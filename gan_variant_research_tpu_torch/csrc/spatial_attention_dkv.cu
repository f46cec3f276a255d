// Spatial self-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces _flash_attention_bwd_dkv of the Pallas TPU flash-attention
// kernel (jax/experimental/pallas/ops/tpu/flash_attention.py:941, body
// _flash_attention_dkv_kernel) behind gan_variant_research_tpu/models/
// attention.py::flash_spatial_attention: the key and value gradients of the
// variant generator's SAGAN core, n = 4096, d_qk = 32, d_v = 256.
//
// Contract (the library kernel's, sm_scale = 1, non-causal):
//   q, k (B, n, d_qk), v, do (B, n, d_v), one dtype, float32 or bfloat16,
//   contiguous; lse (B, n) float32 from the forward; di (B, n) float32 =
//   sum(o * do) over d_v (computed outside, as the library does).
//   p = exp(q k^T - lse) in float32;
//   dV = p^T do, with p rounded to do's dtype before the product;
//   dp = do v^T in float32, ds = p (dp - di), rounded to do's dtype;
//   dK = ds^T q. Sums in float32, dk and dv cast once to the input dtype.
//   One head of width d_v: the library's 128-wide heads share p, so their
//   dk sum over heads is this dk, up to the rounding of ds (once here, once
//   per head there).
//
// What bounds it. 2 n^2 (2 d_qk + 2 d_v) operations per image (p recomputed,
// dV, dp, dK): 240 GFLOP at B = 12, against ~60 MB of inputs and outputs:
// operation-bound on the tensor cores.
//
// What this design does about it. Block (64 keys, one image) keeps its K
// and V tiles in shared memory and walks the queries in tiles of 64, the
// q, do, lse and di tiles staged by cp.async two deep; dK and dV stay in
// registers until the end, so each block owns its output rows: no atomics,
// the same bits from run to run. bf16: 8 warps; warp (key group kg of 16,
// half h of d_v) computes p^T (16 keys x 64 queries, the key-major form, so
// that p^T's accumulator registers are the A fragments of dV += p^T do),
// its dV half (16 x d_v/2 in registers: the full 64 x 256 float32 dV would
// not fit one warp group's registers) and its half of the dp^T contraction
// over d_v; the two halves of dp^T meet in shared memory, and each warp then
// takes half of dK's d_qk columns. float32: FMA (never TF32), p and ds
// through shared memory. wgmma, TMA and pipelining come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8; register i holds (row g, cols 2t, 2t+1) of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Transposed: register i holds (rows 2t, 2t+1, col g) of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two transposed matrices, addressed by lanes 0-15.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync. DQK: d_qk padded to 16, 32 or 64; DVH: half of d_v
// padded to 64 or 128. Shared-memory rows padded by 8 elements.

constexpr int XS = BQ + 4;   // padded row stride of the dp^T exchange

template <int DQK, int DVH>
__global__ void __launch_bounds__(256, 1)
attn_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv_out, int n, int dqk, int dv) {
  constexpr int DV = 2 * DVH;
  constexpr int QS = DQK + 8;
  constexpr int VS = DV + 8;
  constexpr int DKH = DQK / 2;   // dK columns a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][QS]
  bf16* vs = ks + BK * QS;                         // [BK][VS]
  bf16* qs = vs + BK * VS;                         // [2][BQ][QS]
  bf16* dos = qs + 2 * BQ * QS;                    // [2][BQ][VS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * VS);   // [2][BQ], log2 units
  float* di_s = lse_s + 2 * BQ;                                 // [2][BQ]
  float* xs = di_s + 2 * BQ;                                    // [2 halves][4 groups][16][XS]

  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kg = warp & 3;    // keys kg*16 .. +16
  const int half = warp >> 2; // d_v columns half*DVH .. +DVH, dK columns half*DKH .. +DKH
  const bf16* qb = q + (size_t)b * n * dqk;
  const bf16* kb = k + (size_t)b * n * dqk;
  const bf16* vb = v + (size_t)b * n * dv;
  const bf16* dob = dout + (size_t)b * n * dv;
  const float* lseb = lse + (size_t)b * n;
  const float* dib = di + (size_t)b * n;

  for (int i = tid; i < BK * (DQK / 8); i += 256) {
    const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
    const bool ok = k0 + r < n && c < dqk;
    cp_async16(&ks[r * QS + c], ok ? kb + (size_t)(k0 + r) * dqk + c : kb, ok);
  }
  for (int i = tid; i < BK * (DV / 8); i += 256) {
    const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
    const bool ok = k0 + r < n && c < dv;
    cp_async16(&vs[r * VS + c], ok ? vb + (size_t)(k0 + r) * dv + c : vb, ok);
  }
  // queries past n: q and do zero, lse +inf so that p = 0
  auto stage = [&](int i0, int buf) {
    for (int i = tid; i < BQ * (DQK / 8); i += 256) {
      const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
      const bool ok = i0 + r < n && c < dqk;
      cp_async16(&qs[(buf * BQ + r) * QS + c], ok ? qb + (size_t)(i0 + r) * dqk + c : qb, ok);
    }
    for (int i = tid; i < BQ * (DV / 8); i += 256) {
      const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
      const bool ok = i0 + r < n && c < dv;
      cp_async16(&dos[(buf * BQ + r) * VS + c], ok ? dob + (size_t)(i0 + r) * dv + c : dob, ok);
    }
    if (tid < BQ) {
      const bool ok = i0 + tid < n;
      lse_s[buf * BQ + tid] = ok ? lseb[i0 + tid] * LOG2E : INFINITY;
      di_s[buf * BQ + tid] = ok ? dib[i0 + tid] : 0.f;
    }
  };

  const int nq = (n + BQ - 1) / BQ;
  stage(0, 0);
  cp_async_commit();

  float dv_acc[DVH / 8][4];
  float dk_acc[DKH / 8][4];
#pragma unroll
  for (int j = 0; j < DVH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DKH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = 0.f;
  uint32_t kf[DQK / 16][4];
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;   // A / trans-B row of this lane
  const int lcol = (lane / 16) * 8;
  const int brow = (lane % 8) + (lane / 16) * 8;        // non-trans B row (n)
  const int bcol = ((lane / 8) % 2) * 8;
  float* x_mine = xs + (half * 4 + kg) * 16 * XS;
  const float* x_other = xs + ((half ^ 1) * 4 + kg) * 16 * XS;

  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1;
    if (it + 1 < nq) stage((it + 1) * BQ, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldsm_x4(kf[kk], &ks[(kg * 16 + lrow) * QS + kk * 16 + lcol]);
    }
    const bf16* qt = qs + buf * BQ * QS;
    const bf16* dot = dos + buf * BQ * VS;
    const float* lt = lse_s + buf * BQ;
    const float* dt = di_s + buf * BQ;

    // p^T = exp(k q^T - lse): 16 keys x 64 queries
    float p[BQ / 8][4];
#pragma unroll
    for (int jt = 0; jt < BQ / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[jt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BQ / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &qt[(jp * 16 + brow) * QS + kk * 16 + bcol]);
        mma_bf16(p[2 * jp], kf[kk], r[0], r[1]);
        mma_bf16(p[2 * jp + 1], kf[kk], r[2], r[3]);
      }
#pragma unroll
    for (int jt = 0; jt < BQ / 8; ++jt) {
      const float l0 = lt[jt * 8 + 2 * t], l1 = lt[jt * 8 + 2 * t + 1];
      p[jt][0] = exp2f(p[jt][0] * LOG2E - l0);
      p[jt][1] = exp2f(p[jt][1] * LOG2E - l1);
      p[jt][2] = exp2f(p[jt][2] * LOG2E - l0);
      p[jt][3] = exp2f(p[jt][3] * LOG2E - l1);
    }

    // dV[kg, half] += bf16(p^T) do[:, half]
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < DVH / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, &dot[(kk * 16 + lrow) * VS + half * DVH + jp * 16 + lcol]);
        mma_bf16(dv_acc[2 * jp], a, r[0], r[1]);
        mma_bf16(dv_acc[2 * jp + 1], a, r[2], r[3]);
      }
    }

    // this half's share of dp^T = v do^T (contraction over d_v)
    float dp[BQ / 8][4];
#pragma unroll
    for (int jt = 0; jt < BQ / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[jt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DVH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, &vs[(kg * 16 + lrow) * VS + half * DVH + kk * 16 + lcol]);
#pragma unroll
      for (int jp = 0; jp < BQ / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &dot[(jp * 16 + brow) * VS + half * DVH + kk * 16 + bcol]);
        mma_bf16(dp[2 * jp], a, r[0], r[1]);
        mma_bf16(dp[2 * jp + 1], a, r[2], r[3]);
      }
    }
#pragma unroll
    for (int jt = 0; jt < BQ / 8; ++jt) {
      *reinterpret_cast<float2*>(&x_mine[g * XS + jt * 8 + 2 * t]) = make_float2(dp[jt][0], dp[jt][1]);
      *reinterpret_cast<float2*>(&x_mine[(g + 8) * XS + jt * 8 + 2 * t]) =
          make_float2(dp[jt][2], dp[jt][3]);
    }
    __syncthreads();
    // ds^T = p^T (dp^T - di), both halves of the contraction in one order
    // (half 0's share first) so that the two warps of a key group agree
#pragma unroll
    for (int jt = 0; jt < BQ / 8; ++jt) {
      const float2 o0 = *reinterpret_cast<const float2*>(&x_other[g * XS + jt * 8 + 2 * t]);
      const float2 o1 = *reinterpret_cast<const float2*>(&x_other[(g + 8) * XS + jt * 8 + 2 * t]);
      const float d0 = dt[jt * 8 + 2 * t], d1 = dt[jt * 8 + 2 * t + 1];
      const float s0 = half ? o0.x + dp[jt][0] : dp[jt][0] + o0.x;
      const float s1 = half ? o0.y + dp[jt][1] : dp[jt][1] + o0.y;
      const float s2 = half ? o1.x + dp[jt][2] : dp[jt][2] + o1.x;
      const float s3 = half ? o1.y + dp[jt][3] : dp[jt][3] + o1.y;
      p[jt][0] *= s0 - d0;
      p[jt][1] *= s1 - d1;
      p[jt][2] *= s2 - d0;
      p[jt][3] *= s3 - d1;
    }

    // dK[kg, this warp's d_qk half] += bf16(ds^T) q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int jt = 0; jt < DKH / 8; ++jt) {
        uint32_t r[2];
        ldsm_x2_trans(r, &qt[(kk * 16 + lrow) * QS + half * DKH + jt * 8]);
        mma_bf16(dk_acc[jt], a, r[0], r[1]);
      }
    }
    __syncthreads();   // the q / do buffer and the exchange are reused
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kg * 16 + g + 8 * h;
    if (key >= n) continue;
    bf16* vrow = dv_out + ((size_t)b * n + key) * dv + half * DVH;
#pragma unroll
    for (int jt = 0; jt < DVH / 8; ++jt)
      if (half * DVH + jt * 8 < dv)
        *reinterpret_cast<__nv_bfloat162*>(vrow + jt * 8 + 2 * t) =
            __floats2bfloat162_rn(dv_acc[jt][2 * h], dv_acc[jt][2 * h + 1]);
    bf16* krow = dk + ((size_t)b * n + key) * dqk + half * DKH;
#pragma unroll
    for (int jt = 0; jt < DKH / 8; ++jt)
      if (half * DKH + jt * 8 < dqk)
        *reinterpret_cast<__nv_bfloat162*>(krow + jt * 8 + 2 * t) =
            __floats2bfloat162_rn(dk_acc[jt][2 * h], dk_acc[jt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32 on FMA: 256 threads; p and ds of a (64 query x 64 key) tile go
// through shared memory; thread (ty, tx) accumulates dV for keys ty + 16a
// and value columns tx + 16c, dK for the same keys and d_qk columns tx + 16c.

constexpr int PS = BK + 1;

__global__ void __launch_bounds__(256, 1)
attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dk, float* __restrict__ dv_out, int n, int dqk, int dv) {
  extern __shared__ float smf[];
  const int QS = dqk + 1, VS = dv + 1;
  float* ks = smf;                 // [BK][QS]
  float* vs = ks + BK * QS;        // [BK][VS]
  float* qs = vs + BK * VS;        // [BQ][QS]
  float* dos = qs + BQ * QS;       // [BQ][VS]
  float* ps = dos + BQ * VS;       // [BQ][PS]
  float* dss = ps + BQ * PS;       // [BQ][PS]
  float* lse_s = dss + BQ * PS;    // [BQ]
  float* di_s = lse_s + BQ;        // [BQ]

  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)b * n * dqk;
  const float* kb = k + (size_t)b * n * dqk;
  const float* vb = v + (size_t)b * n * dv;
  const float* dob = dout + (size_t)b * n * dv;

  for (int i = tid; i < BK * dqk; i += 256) {
    const int r = i / dqk, c = i % dqk;
    ks[r * QS + c] = k0 + r < n ? kb[(size_t)(k0 + r) * dqk + c] : 0.f;
  }
  for (int i = tid; i < BK * dv; i += 256) {
    const int r = i / dv, c = i % dv;
    vs[r * VS + c] = k0 + r < n ? vb[(size_t)(k0 + r) * dv + c] : 0.f;
  }
  float dv_acc[4][16], dk_acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 16; ++c) dv_acc[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[a][c] = 0.f;
  }

  const int nq = (n + BQ - 1) / BQ;
  for (int it = 0; it < nq; ++it) {
    const int i0 = it * BQ;
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < BQ * dqk; i += 256) {
      const int r = i / dqk, c = i % dqk;
      qs[r * QS + c] = i0 + r < n ? qb[(size_t)(i0 + r) * dqk + c] : 0.f;
    }
    for (int i = tid; i < BQ * dv; i += 256) {
      const int r = i / dv, c = i % dv;
      dos[r * VS + c] = i0 + r < n ? dob[(size_t)(i0 + r) * dv + c] : 0.f;
    }
    if (tid < BQ) {
      const bool ok = i0 + tid < n;
      lse_s[tid] = ok ? lse[(size_t)b * n + i0 + tid] : INFINITY;
      di_s[tid] = ok ? di[(size_t)b * n + i0 + tid] : 0.f;
    }
    __syncthreads();

    // p and ds for queries ty + 16a, keys tx + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int d = 0; d < dqk; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kv[c], s[a][c]);
    }
    for (int d = 0; d < dv; ++d) {
      float oa[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) oa[a] = dos[(ty + 16 * a) * VS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = vs[(tx + 16 * c) * VS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[a][c] = fmaf(oa[a], vv[c], dp[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float l = lse_s[r], dd = di_s[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[a][c] - l);
        ps[r * PS + tx + 16 * c] = pv;
        dss[r * PS + tx + 16 * c] = pv * (dp[a][c] - dd);
      }
    }
    __syncthreads();

    // dV[key][c] += sum_q p[q][key] do[q][c]; dK[key][d] += sum_q ds[q][key] q[q][d]
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[4], ov[16], qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[r * PS + ty + 16 * a];
        da[a] = dss[r * PS + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) ov[c] = tx + 16 * c < dv ? dos[r * VS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) qv[c] = tx + 16 * c < dqk ? qs[r * QS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 16; ++c) dv_acc[a][c] = fmaf(pa[a], ov[c], dv_acc[a][c]);
#pragma unroll
        for (int c = 0; c < 4; ++c) dk_acc[a][c] = fmaf(da[a], qv[c], dk_acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= n) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (tx + 16 * c < dv) dv_out[((size_t)b * n + key) * dv + tx + 16 * c] = dv_acc[a][c];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tx + 16 * c < dqk) dk[((size_t)b * n + key) * dqk + tx + 16 * c] = dk_acc[a][c];
  }
}

template <int DQK, int DVH>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dk, void* dv_out, int B, int n,
                int dqk, int dv, cudaStream_t st) {
  constexpr int QS = DQK + 8, VS = 2 * DVH + 8;
  const int smem = (BK * QS + BK * VS + 2 * BQ * QS + 2 * BQ * VS) * 2 +
                   (4 * BQ + 2 * 4 * 16 * XS) * 4;
  auto kernel = attn_dkv_bf16<DQK, DVH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BK - 1) / BK, 1, B);
  kernel<<<grid, 256, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv_out),
      n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK>
int launch_bf16_dv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dk, void* dv_out, int B, int n,
                   int dqk, int dv, cudaStream_t st) {
  return dv <= 128
             ? launch_bf16<DQK, 64>(q, k, v, dout, lse, di, dk, dv_out, B, n, dqk, dv, st)
             : launch_bf16<DQK, 128>(q, k, v, dout, lse, di, dk, dv_out, B, n, dqk, dv, st);
}

}  // namespace

// q, k (B, n, dqk), v, dout (B, n, dv) in one dtype (0 = float32,
// 1 = bfloat16); lse, di (B, n) float32; dk (B, n, dqk) and dv_out
// (B, n, dv) in the input dtype. Pointers 16-byte aligned. Returns a
// cudaError_t (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int spatial_attention_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di, void* dk,
                                     void* dv_out, int B, int n, int dqk, int dv, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < 1 || dqk < 8 || dqk > 64 || dqk % 8 || dv < 8 || dv > 256 ||
      dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    if (dqk <= 16) return launch_bf16_dv<16>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_bf16_dv<32>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
    return launch_bf16_dv<64>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * BK * (dqk + 1) + 2 * BK * (dv + 1) + 2 * BQ * PS + 2 * BQ) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(attn_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BK - 1) / BK, 1, B);
  attn_dkv_f32<<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), l, d, static_cast<float*>(dk), static_cast<float*>(dv_out),
      n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}
