// Spatial self-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces _flash_attention_bwd_dq of the Pallas TPU flash-attention kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:1287, body
// _flash_attention_dq_kernel) behind gan_variant_research_tpu/models/
// attention.py::flash_spatial_attention: the query gradient of the variant
// generator's SAGAN core, n = 4096, d_qk = 32, d_v = 256.
//
// Contract (the library kernel's, sm_scale = 1, non-causal):
//   q, k (B, n, d_qk), v, do (B, n, d_v), one dtype, float32 or bfloat16,
//   contiguous; lse, di (B, n) float32 (see spatial_attention_dkv.cu).
//   p = exp(q k^T - lse), dp = do v^T, ds = p (dp - di) in float32; ds is
//   rounded to k's dtype before dQ = ds k, which sums in float32; dq is
//   cast once to the input dtype.
//
// What bounds it. 2 n^2 (2 d_qk + d_v) operations per image (p recomputed,
// dp, dQ): 120 GFLOP at B = 12, against ~30 MB of inputs and output:
// operation-bound on the tensor cores.
//
// What this design does about it. Block (128 query rows, one image) keeps
// its q and do rows in shared memory and walks the keys in tiles of 64, K
// and V staged by cp.async two deep; each of 8 warps owns 16 query rows and
// their dQ in registers, so the block owns its output rows: no atomics, the
// same bits from run to run. bf16: mma.sync m16n8k16; ds goes from the
// accumulator registers straight into the A fragments of ds k. float32:
// FMA (never TF32), ds through shared memory. wgmma, TMA and pipelining
// come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;   // keys per tile

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
// bf16 on mma.sync. DQK: d_qk padded to 16, 32 or 64; DV: d_v padded to 128
// or 256. Shared-memory rows padded by 8 elements.

constexpr int BQ_BF16 = 128;   // 8 warps x 16 query rows

template <int DQK, int DV>
__global__ void __launch_bounds__(256, 1)
attn_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, int n, int dqk, int dv) {
  constexpr int QS = DQK + 8;
  constexpr int VS = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ_BF16][QS]
  bf16* dos = qs + BQ_BF16 * QS;                   // [BQ_BF16][VS]
  bf16* ks = dos + BQ_BF16 * VS;                   // [2][BK][QS]
  bf16* vs = ks + 2 * BK * QS;                     // [2][BK][VS]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ_BF16;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* qb = q + (size_t)b * n * dqk;
  const bf16* kb = k + (size_t)b * n * dqk;
  const bf16* vb = v + (size_t)b * n * dv;
  const bf16* dob = dout + (size_t)b * n * dv;

  for (int i = tid; i < BQ_BF16 * (DQK / 8); i += 256) {
    const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
    const bool ok = q0 + r < n && c < dqk;
    cp_async16(&qs[r * QS + c], ok ? qb + (size_t)(q0 + r) * dqk + c : qb, ok);
  }
  for (int i = tid; i < BQ_BF16 * (DV / 8); i += 256) {
    const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
    const bool ok = q0 + r < n && c < dv;
    cp_async16(&dos[r * VS + c], ok ? dob + (size_t)(q0 + r) * dv + c : dob, ok);
  }
  auto stage = [&](int j, int buf) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * (DQK / 8); i += 256) {
      const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
      const bool ok = k0 + r < n && c < dqk;
      cp_async16(&ks[(buf * BK + r) * QS + c], ok ? kb + (size_t)(k0 + r) * dqk + c : kb, ok);
    }
    for (int i = tid; i < BK * (DV / 8); i += 256) {
      const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
      const bool ok = k0 + r < n && c < dv;
      cp_async16(&vs[(buf * BK + r) * VS + c], ok ? vb + (size_t)(k0 + r) * dv + c : vb, ok);
    }
  };

  const int nk = (n + BK - 1) / BK;
  stage(0, 0);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16: lse in log2 units (+inf past n, so
  // that p = 0) and di
  float l_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    l_r[h] = row < n ? lse[(size_t)b * n + row] * LOG2E : INFINITY;
    d_r[h] = row < n ? di[(size_t)b * n + row] : 0.f;
  }
  float acc[DQK / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[DQK / 16][4];
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;
  const int lcol = (lane / 16) * 8;
  const int brow = (lane % 8) + (lane / 16) * 8;
  const int bcol = ((lane / 8) % 2) * 8;
  const bf16* dor = dos + (warp * 16 + lrow) * VS + lcol;   // this lane's do A address

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) stage(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldsm_x4(qf[kk], &qs[(warp * 16 + lrow) * QS + kk * 16 + lcol]);
    }
    const bf16* kt = ks + buf * BK * QS;
    const bf16* vt = vs + buf * BK * VS;

    // p = exp(q k^T - lse): 16 rows x 64 keys a warp; keys past n give 0
    float p[BK / 8][4];
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[jt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &kt[(jp * 16 + brow) * QS + kk * 16 + bcol]);
        mma_bf16(p[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(p[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    const int k0 = j * BK;
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[jt][e] = k0 + jt * 8 + 2 * t + (e & 1) < n
                       ? exp2f(p[jt][e] * LOG2E - l_r[e >> 1]) : 0.f;

    // dp = do v^T, contraction over d_v
    float dp[BK / 8][4];
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[jt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, dor + kk * 16);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &vt[(jp * 16 + brow) * VS + kk * 16 + bcol]);
        mma_bf16(dp[2 * jp], a, r[0], r[1]);
        mma_bf16(dp[2 * jp + 1], a, r[2], r[3]);
      }
    }

    // dQ += bf16(p (dp - di)) k
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kk][0] * (dp[2 * kk][0] - d_r[0]),
                       p[2 * kk][1] * (dp[2 * kk][1] - d_r[0]));
      a[1] = pack_bf16(p[2 * kk][2] * (dp[2 * kk][2] - d_r[1]),
                       p[2 * kk][3] * (dp[2 * kk][3] - d_r[1]));
      a[2] = pack_bf16(p[2 * kk + 1][0] * (dp[2 * kk + 1][0] - d_r[0]),
                       p[2 * kk + 1][1] * (dp[2 * kk + 1][1] - d_r[0]));
      a[3] = pack_bf16(p[2 * kk + 1][2] * (dp[2 * kk + 1][2] - d_r[1]),
                       p[2 * kk + 1][3] * (dp[2 * kk + 1][3] - d_r[1]));
#pragma unroll
      for (int jp = 0; jp < DQK / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, &kt[(kk * 16 + lrow) * QS + jp * 16 + lcol]);
        mma_bf16(acc[2 * jp], a, r[0], r[1]);
        mma_bf16(acc[2 * jp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();   // this buffer is refilled next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* qrow = dq + ((size_t)b * n + row) * dqk;
#pragma unroll
    for (int jt = 0; jt < DQK / 8; ++jt)
      if (jt * 8 < dqk)
        *reinterpret_cast<__nv_bfloat162*>(qrow + jt * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[jt][2 * h], acc[jt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32 on FMA: 256 threads, 64 query rows a block; ds of a (64 x 64)
// tile goes through shared memory; thread (ty, tx) accumulates dQ for rows
// ty + 16a and d_qk columns tx + 16c.

constexpr int BQ_F32 = 64;
constexpr int PS = BK + 1;

__global__ void __launch_bounds__(256, 1)
attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dq, int n, int dqk, int dv) {
  extern __shared__ float smf[];
  const int QS = dqk + 1, VS = dv + 1;
  float* qs = smf;                  // [BQ_F32][QS]
  float* dos = qs + BQ_F32 * QS;    // [BQ_F32][VS]
  float* ks = dos + BQ_F32 * VS;    // [BK][QS]
  float* vs = ks + BK * QS;         // [BK][VS]
  float* dss = vs + BK * VS;        // [BQ_F32][PS]
  float* lse_s = dss + BQ_F32 * PS; // [BQ_F32]
  float* di_s = lse_s + BQ_F32;     // [BQ_F32]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ_F32;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)b * n * dqk;
  const float* kb = k + (size_t)b * n * dqk;
  const float* vb = v + (size_t)b * n * dv;
  const float* dob = dout + (size_t)b * n * dv;

  for (int i = tid; i < BQ_F32 * dqk; i += 256) {
    const int r = i / dqk, c = i % dqk;
    qs[r * QS + c] = q0 + r < n ? qb[(size_t)(q0 + r) * dqk + c] : 0.f;
  }
  for (int i = tid; i < BQ_F32 * dv; i += 256) {
    const int r = i / dv, c = i % dv;
    dos[r * VS + c] = q0 + r < n ? dob[(size_t)(q0 + r) * dv + c] : 0.f;
  }
  if (tid < BQ_F32) {
    const bool ok = q0 + tid < n;
    lse_s[tid] = ok ? lse[(size_t)b * n + q0 + tid] : INFINITY;
    di_s[tid] = ok ? di[(size_t)b * n + q0 + tid] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  const int nk = (n + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < BK * dqk; i += 256) {
      const int r = i / dqk, c = i % dqk;
      ks[r * QS + c] = k0 + r < n ? kb[(size_t)(k0 + r) * dqk + c] : 0.f;
    }
    for (int i = tid; i < BK * dv; i += 256) {
      const int r = i / dv, c = i % dv;
      vs[r * VS + c] = k0 + r < n ? vb[(size_t)(k0 + r) * dv + c] : 0.f;
    }
    __syncthreads();

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
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = k0 + tx + 16 * c < n ? expf(s[a][c] - lse_s[r]) : 0.f;
        dss[r * PS + tx + 16 * c] = pv * (dp[a][c] - di_s[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float da[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(ty + 16 * a) * PS + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = tx + 16 * c < dqk ? ks[kk * QS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(da[a], kv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tx + 16 * c < dqk) dq[((size_t)b * n + row) * dqk + tx + 16 * c] = acc[a][c];
  }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dq, int B, int n, int dqk, int dv,
                cudaStream_t st) {
  const int smem = (BQ_BF16 * (DQK + 8) + BQ_BF16 * (DV + 8) + 2 * BK * (DQK + 8) +
                    2 * BK * (DV + 8)) * 2;
  auto kernel = attn_dq_bf16<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ_BF16 - 1) / BQ_BF16, 1, B);
  kernel<<<grid, 256, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                                  lse, di, static_cast<bf16*>(dq), n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK>
int launch_bf16_dv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dq, int B, int n, int dqk, int dv,
                   cudaStream_t st) {
  return dv <= 128 ? launch_bf16<DQK, 128>(q, k, v, dout, lse, di, dq, B, n, dqk, dv, st)
                   : launch_bf16<DQK, 256>(q, k, v, dout, lse, di, dq, B, n, dqk, dv, st);
}

}  // namespace

// q, k (B, n, dqk), v, dout (B, n, dv) in one dtype (0 = float32,
// 1 = bfloat16); lse, di (B, n) float32; dq (B, n, dqk) in the input dtype.
// Pointers 16-byte aligned. Returns a cudaError_t (0 = cudaSuccess); the
// launch is asynchronous on `stream`.
extern "C" int spatial_attention_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di, void* dq,
                                    int B, int n, int dqk, int dv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < 1 || dqk < 8 || dqk > 64 || dqk % 8 || dv < 8 || dv > 256 ||
      dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    if (dqk <= 16) return launch_bf16_dv<16>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_bf16_dv<32>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
    return launch_bf16_dv<64>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * BQ_F32 * (dqk + 1) + 2 * BK * (dv + 1) + BQ_F32 * PS + 2 * BQ_F32) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(attn_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ_F32 - 1) / BQ_F32, 1, B);
  attn_dq_f32<<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), l, d, static_cast<float*>(dq), n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}
