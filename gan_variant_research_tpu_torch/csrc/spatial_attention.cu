// Spatial self-attention forward, o = softmax(q k^T) v, for Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU flash-attention kernel that
// gan_variant_research_tpu/models/attention.py::flash_spatial_attention
// calls (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_impl, body _flash_attention_kernel_single_batch): the
// core of the variant generator's SAGAN blocks, at the 64x64 trunk
// n = 4096 keys and queries, d_qk = C/8 = 32, d_v = C = 256.
//
// Contract (the library kernel's, with sm_scale = 1, non-causal):
//   q, k (B, n, d_qk), v (B, n, d_v), one dtype, float32 or bfloat16,
//   contiguous; 8 <= d_qk <= 64 and 8 <= d_v <= 256, both multiples of 8.
//   s = q k^T in float32 (bf16 x bf16 products are exact in float32), an
//   online softmax in float32; bf16: the unnormalised p is rounded to
//   bf16 before the p v product, which sums in float32; o is cast once to
//   the input dtype. lse (B, n) float32 = the row's log-sum-exp, saved for
//   the backward (the library saves the row max and sum).
//   One head: no pad of q, k to 128 and no split of v into heads, which
//   exist only for the TPU kernel; the heads of the library share p, so
//   one head of width d_v is the same function.
//
// What bounds it. 2 n^2 (d_qk + d_v) operations per image: at B = 12
// 116 GFLOP, against 40 MB of inputs and output. Operation-bound on the
// tensor cores (0.117 ms at 989 TFLOP/s), plus n^2 exponentials.
//
// What this design does about it. The (n, n) map never exists: block
// (64 query rows, a d_v slice of DVT, one image) walks the keys in tiles
// of 64, K and V tiles staged by cp.async two deep. bf16: 4 warps of 16
// query rows; s on mma.sync m16n8k16 (ldmatrix fragments), its float32
// accumulator rescaled online, p packed from the accumulator registers
// straight into the A fragments of the p v product. The 64 x 256 float32
// accumulator of a full d_v would not fit in registers, so d_v is split
// over blocks (DVT = 128) and s is recomputed per slice: d_qk / d_v = 12.5%
// more work. float32: FMA (never TF32) with s and p in shared memory.
// wgmma, TMA and warp specialisation come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;   // query rows per block
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

// The same, transposed: register i holds (rows 2t, 2t+1, col g) of matrix i.
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
// bf16 on mma.sync. DQK: d_qk padded to 16, 32 or 64 (zero columns add
// nothing to s); DVT: the d_v slice of a block. Shared memory rows are
// padded by 8 elements so that ldmatrix's 8 rows hit distinct banks.

template <int DQK, int DVT>
__global__ void __launch_bounds__(128)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int n, int dqk, int dv) {
  constexpr int QS = DQK + 8;
  constexpr int VS = DVT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][QS]
  bf16* ks = qs + BQ * QS;                         // [2][BK][QS]
  bf16* vs = ks + 2 * BK * QS;                     // [2][BK][VS]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.y * DVT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* qb = q + (size_t)b * n * dqk;
  const bf16* kb = k + (size_t)b * n * dqk;
  const bf16* vb = v + (size_t)b * n * dv;

  for (int i = tid; i < BQ * (DQK / 8); i += 128) {
    const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
    const bool ok = q0 + r < n && c < dqk;
    cp_async16(&qs[r * QS + c], ok ? qb + (size_t)(q0 + r) * dqk + c : qb, ok);
  }
  auto stage = [&](int j, int buf) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * (DQK / 8); i += 128) {
      const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
      const bool ok = k0 + r < n && c < dqk;
      cp_async16(&ks[(buf * BK + r) * QS + c], ok ? kb + (size_t)(k0 + r) * dqk + c : kb, ok);
    }
    for (int i = tid; i < BK * (DVT / 8); i += 128) {
      const int r = i / (DVT / 8), c = (i % (DVT / 8)) * 8;
      const bool ok = k0 + r < n && c0 + c < dv;
      cp_async16(&vs[(buf * BK + r) * VS + c], ok ? vb + (size_t)(k0 + r) * dv + c0 + c : vb, ok);
    }
  };

  const int nk = (n + BK - 1) / BK;
  stage(0, 0);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16: running max (log2 units) and this
  // thread's share of the running sum
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[DVT / 8][4];
#pragma unroll
  for (int j = 0; j < DVT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[DQK / 16][4];
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8;   // A / trans-B row of this lane
  const int lcol = (lane / 16) * 8;                     // its column offset
  const int brow = (lane % 8) + (lane / 16) * 8;        // non-trans B row (n)
  const int bcol = ((lane / 8) % 2) * 8;                // its column offset (k)

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

    // s = q k^T: 16 rows x 64 keys a warp
    float s[BK / 8][4];
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &kt[(jp * 16 + brow) * QS + kk * 16 + bcol]);
        mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }

    // online softmax in log2 units; keys past n weigh nothing
    const int k0 = j * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + jt * 8 + 2 * t + (e & 1) < n;
        s[jt][e] = ok ? s[jt][e] * LOG2E : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);   // finite: every tile has a key
      alpha[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int jt = 0; jt < BK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jt][e] = exp2f(s[jt][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[jt][e];
      }
#pragma unroll
    for (int jt = 0; jt < DVT / 8; ++jt) {
      acc[jt][0] *= alpha[0];
      acc[jt][1] *= alpha[0];
      acc[jt][2] *= alpha[1];
      acc[jt][3] *= alpha[1];
    }

    // acc += bf16(p) v: p's accumulator registers are the A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < DVT / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, &vt[(kk * 16 + lrow) * VS + jp * 16 + lcol]);
        mma_bf16(acc[2 * jp], a, r[0], r[1]);
        mma_bf16(acc[2 * jp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();   // this buffer is refilled next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* orow = o + ((size_t)b * n + row) * dv + c0;
#pragma unroll
    for (int jt = 0; jt < DVT / 8; ++jt) {
      if (c0 + jt * 8 < dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + jt * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[jt][2 * h] * inv[h], acc[jt][2 * h + 1] * inv[h]);
    }
    if (blockIdx.y == 0 && t == 0) lse[(size_t)b * n + row] = (m_r[h] + log2f(l_r[h])) * LN2;
  }
}

// ---------------------------------------------------------------------------
// float32 on FMA: 256 threads, each 4 query rows x 4 keys of s and 4 rows x
// 4 value columns of the accumulator (rows ty + 16a, columns tx + 16b, so
// that a warp reads consecutive shared-memory words).

constexpr int DVT_F32 = 64;
constexpr int PS = BK + 1;   // padded row stride of p

__global__ void __launch_bounds__(256)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int n, int dqk, int dv) {
  extern __shared__ float smf[];
  const int QS = dqk + 1;
  float* qs = smf;                        // [BQ][QS]
  float* ks = qs + BQ * QS;               // [BK][QS]
  float* vs = ks + BK * QS;               // [BK][PS]: DVT_F32 columns
  float* ps = vs + BK * PS;               // [BQ][PS]
  float* m_s = ps + BQ * PS;              // [BQ]
  float* l_s = m_s + BQ;                  // [BQ]
  float* alpha_s = l_s + BQ;              // [BQ]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.y * DVT_F32;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)b * n * dqk;
  const float* kb = k + (size_t)b * n * dqk;
  const float* vb = v + (size_t)b * n * dv;

  for (int i = tid; i < BQ * dqk; i += 256) {
    const int r = i / dqk, c = i % dqk;
    qs[r * QS + c] = q0 + r < n ? qb[(size_t)(q0 + r) * dqk + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  const int nk = (n + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int i = tid; i < BK * dqk; i += 256) {
      const int r = i / dqk, c = i % dqk;
      ks[r * QS + c] = k0 + r < n ? kb[(size_t)(k0 + r) * dqk + c] : 0.f;
    }
    for (int i = tid; i < BK * DVT_F32; i += 256) {
      const int r = i / DVT_F32, c = i % DVT_F32;
      vs[r * PS + c] = (k0 + r < n && c0 + c < dv) ? vb[(size_t)(k0 + r) * dv + c0 + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
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
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty + 16 * a) * PS + tx + 16 * c] = k0 + tx + 16 * c < n ? s[a][c] : -INFINITY;
    __syncthreads();

    {  // row softmax: four neighbouring lanes a row, 16 keys each
      const int row = tid >> 2, part = tid & 3;
      float* prow = ps + row * PS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();   // every lane of the row has read m_s[row]
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
        alpha_s[row] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = alpha_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] *= al;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * PS + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = vs[kk * PS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pa[a], vv[c], acc[a][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= n) continue;
    const float inv = 1.f / l_s[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < dv) o[((size_t)b * n + q0 + r) * dv + col] = acc[a][c] * inv;
    }
  }
  if (blockIdx.y == 0 && tid < BQ && q0 + tid < n)
    lse[(size_t)b * n + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int DQK, int DVT>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int n, int dqk, int dv, cudaStream_t st) {
  const int smem = (BQ * (DQK + 8) + 2 * BK * (DQK + 8) + 2 * BK * (DVT + 8)) * 2;
  auto kernel = attn_fwd_bf16<DQK, DVT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, (dv + DVT - 1) / DVT, B);
  kernel<<<grid, 128, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                  static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, n,
                                  dqk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK>
int launch_bf16_dv(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int n, int dqk, int dv, cudaStream_t st) {
  return dv <= 64 ? launch_bf16<DQK, 64>(q, k, v, o, lse, B, n, dqk, dv, st)
                  : launch_bf16<DQK, 128>(q, k, v, o, lse, B, n, dqk, dv, st);
}

}  // namespace

// q, k (B, n, dqk), v (B, n, dv) in one dtype (0 = float32, 1 = bfloat16);
// o (B, n, dv) in that dtype; lse (B, n) float32. Pointers 16-byte aligned.
// Returns a cudaError_t (0 = cudaSuccess, cudaErrorInvalidValue for shapes
// outside the contract); the launch is asynchronous on `stream`.
extern "C" int spatial_attention_forward(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int n, int dqk, int dv, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < 1 || dqk < 8 || dqk > 64 || dqk % 8 || dv < 8 || dv > 256 ||
      dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    if (dqk <= 16) return launch_bf16_dv<16>(q, k, v, o, l, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_bf16_dv<32>(q, k, v, o, l, B, n, dqk, dv, st);
    return launch_bf16_dv<64>(q, k, v, o, l, B, n, dqk, dv, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * BQ * (dqk + 1) + 2 * BK * PS + 3 * BQ) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, (dv + DVT_F32 - 1) / DVT_F32, B);
  attn_fwd_f32<<<grid, 256, smem, st>>>(static_cast<const float*>(q),
                                        static_cast<const float*>(k),
                                        static_cast<const float*>(v), static_cast<float*>(o), l,
                                        n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}
