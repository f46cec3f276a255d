// Weight gradient of reflect-pad(1) + 3x3 conv, NHWC, for Hopper (sm_90a).
//
// Replaces gan_variant_research_tpu/ops/pallas/resblock.py::_dw_pallas (body
// _dw_kernel): the weight gradient of every residual-trunk conv, 18 per
// ResNet-9 pass at (B, 64, 64, 256).
//
// Contract (the same as the TPU kernel's):
//   x (N, H, W, Cin), dy (N, H, W, Cout), both float32 or both bfloat16, NHWC
//   contiguous, H >= 2, W >= 2;
//   dw (3, 3, Cin, Cout) float32 = sum over n, h, w of
//   xr[n][h+ky-1][w+kx-1][ci] * dy[n][h][w][co], where xr is x reflected at
//   the border. Products are exact in float32 (bf16 x bf16) or float32, sums
//   are float32. The result is bitwise the same from run to run.
//
// What bounds it. Nine (N*H*W, Cin)^T (N*H*W, Cout) products: at B = 12 the
// trunk reduces over 49,152 pixels into 589,824 float32 outputs, ~58 GFLOP,
// compute-bound on the tensor cores. The TPU kernel carries the sum across
// its sequential grid; on Hopper blocks run in no order, and the outputs
// alone give only 48 blocks of 64x64 channels x 3 taps, too few for 132 SMs.
//
// What this design does about that. The pixel reduction is split:
//   1. dw_partial: block (ci tile of 64, co tile of 64, kernel row ky, split
//      s) walks its share of the image-row segments (64 pixels of one row)
//      in order, and accumulates the three taps (ky, 0..2) of its tile in
//      registers. Per segment it stages dy [64 px x 64 co] and the reflected
//      x row h+ky-1 [66 px x 64 ci] (the halo of one pixel each side, so the
//      pad exists only in shared memory). bf16: mma.sync m16n8k16 with
//      float32 accumulation, M = ci, N = co, K = pixels; both operands are
//      staged in their NHWC layout by cp.async 16-byte copies, two segments
//      deep, and ldmatrix.trans turns them into the k-major fragments; each
//      warp owns 16 ci x 32 co x 3 taps. float32: FMA (never TF32), each
//      thread 4 ci x 4 co x 3 taps. The block writes its float32 partial
//      sums to a scratch buffer (S, 3, 3, Cin, Cout).
//   2. dw_reduce: dw = the sum of the S partials in order s = 0..S-1.
// No atomics, so the sum's order is fixed and the result deterministic. The
// wrapper picks S so that pass 1 has a few waves of blocks. wgmma, TMA and
// pipelining come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CI_T = 64;      // input channels per block
constexpr int CO_T = 64;      // output channels per block
constexpr int SEG = 64;       // pixels of one image row per segment
constexpr int XQ = SEG + 2;   // x halo columns
constexpr int THREADS = 256;

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Segment range of split s: [s * total / S, (s + 1) * total / S).
__device__ __forceinline__ void split_range(long long total, int s, int S,
                                            long long* lo, long long* hi) {
  *lo = total * s / S;
  *hi = total * (s + 1) / S;
}

// ---------------------------------------------------------------------------
// float32 on FMA

__global__ void __launch_bounds__(THREADS)
dw_partial_f32(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ part, int N, int H, int W, int Cin, int Cout,
               int S) {
  __shared__ __align__(16) float xs[XQ * CI_T];     // [q][ci]
  __shared__ __align__(16) float dys[SEG * CO_T];   // [p][co]

  const int ci0 = blockIdx.x * CI_T;
  const int co0 = blockIdx.y * CO_T;
  const int ky = blockIdx.z % 3;
  const int s = blockIdx.z / 3;
  const int tid = threadIdx.x;
  const int tc = tid % 16;   // co group of 4
  const int tr = tid / 16;   // ci group of 4
  const int segs_w = (W + SEG - 1) / SEG;

  float acc[3][4][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[k][a][b] = 0.f;

  long long lo, hi;
  split_range((long long)N * H * segs_w, s, S, &lo, &hi);
  for (long long seg = lo; seg < hi; ++seg) {
    const int w0 = (int)(seg % segs_w) * SEG;
    const int h = (int)((seg / segs_w) % H);
    const int n = (int)(seg / ((long long)segs_w * H));
    const int hr = reflect_index(h + ky - 1, H);
    const float* xrow = x + ((size_t)n * H + hr) * W * Cin;
    const float* dyrow = dy + ((size_t)n * H + h) * W * Cout;
    for (int i = tid; i < XQ * CI_T; i += THREADS) {
      const int c = i % CI_T, q = i / CI_T;
      const int gx = reflect_index(w0 - 1 + q, W);
      xs[i] = ci0 + c < Cin ? xrow[(size_t)gx * Cin + ci0 + c] : 0.f;
    }
    for (int i = tid; i < SEG * CO_T; i += THREADS) {
      const int c = i % CO_T, p = i / CO_T;
      dys[i] = (co0 + c < Cout && w0 + p < W) ? dyrow[(size_t)(w0 + p) * Cout + co0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < SEG; ++p) {
      const float4 d = *reinterpret_cast<const float4*>(dys + p * CO_T + tc * 4);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (p + kx) * CI_T + tr * 4);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[kx][a][0] = fmaf(xa[a], d.x, acc[kx][a][0]);
          acc[kx][a][1] = fmaf(xa[a], d.y, acc[kx][a][1]);
          acc[kx][a][2] = fmaf(xa[a], d.z, acc[kx][a][2]);
          acc[kx][a][3] = fmaf(xa[a], d.w, acc[kx][a][3]);
        }
      }
    }
    __syncthreads();
  }

  float* ps = part + (size_t)s * 9 * Cin * Cout;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ci = ci0 + tr * 4 + a;
      if (ci >= Cin) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int co = co0 + tc * 4 + b;
        if (co < Cout) ps[((size_t)(ky * 3 + kx) * Cin + ci) * Cout + co] = acc[kx][a][b];
      }
    }
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16: A = x^T (ci x pixels), B = dy (pixels x co)

constexpr int KS = 72;   // padded bf16 stride of a pixel's channel row in shared memory

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

// Four transposed 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Stored S[k][m], each register holds (S[2t][g], S[2t+1][g]) of
// its matrix: the A (row-major m x k) or B (k x n, "col") fragment of mma.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
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

// Both operands are staged in their global layout, [pixel][channel]: x's
// reflected row segment (66 pixels, the halo of one each side) and dy's (64
// pixels), two stages deep. vec (Cin, Cout multiples of 8, 16-byte aligned
// tensors): cp.async 16-byte copies, the next segment's in flight while this
// one computes; otherwise element loads and stores.
__global__ void __launch_bounds__(THREADS)
dw_partial_bf16(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ dy, float* __restrict__ part,
                int N, int H, int W, int Cin, int Cout, int S, int vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][XQ * KS];     // [q][ci]
  __shared__ __align__(16) __nv_bfloat16 dys[2][SEG * KS];   // [p][co]

  const int ci0 = blockIdx.x * CI_T;
  const int co0 = blockIdx.y * CO_T;
  const int ky = blockIdx.z % 3;
  const int s = blockIdx.z / 3;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp % 4;   // 16 ci each
  const int wn = warp / 4;   // 32 co each
  const int segs_w = (W + SEG - 1) / SEG;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // ldmatrix: the row this lane addresses, and its 8x8 matrix's offsets
  const int lr = lane % 8;
  const int lk = ((lane / 8) % 2) * 8;   // A: matrices 1, 3 at m + 8; B: at k + 8
  const int lm = (lane / 16) * 8;        // A: matrices 2, 3 at k + 8; B: at n + 8

  float acc[3][4][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[k][j][r] = 0.f;

  long long lo, hi;
  split_range((long long)N * H * segs_w, s, S, &lo, &hi);

  auto stage = [&](long long seg, int buf) {
    const int w0 = (int)(seg % segs_w) * SEG;
    const int h = (int)((seg / segs_w) % H);
    const int n = (int)(seg / ((long long)segs_w * H));
    const int hr = reflect_index(h + ky - 1, H);
    const __nv_bfloat16* xrow = x + ((size_t)n * H + hr) * W * Cin;
    const __nv_bfloat16* dyrow = dy + ((size_t)n * H + h) * W * Cout;
    if (vec) {
      for (int i = tid; i < XQ * (CI_T / 8); i += THREADS) {
        const int q = i / (CI_T / 8), c = (i % (CI_T / 8)) * 8;
        const int gx = reflect_index(w0 - 1 + q, W);
        const bool ok = ci0 + c < Cin;
        cp_async16(&xs[buf][q * KS + c], ok ? xrow + (size_t)gx * Cin + ci0 + c : x, ok);
      }
      for (int i = tid; i < SEG * (CO_T / 8); i += THREADS) {
        const int p = i / (CO_T / 8), c = (i % (CO_T / 8)) * 8;
        const bool ok = w0 + p < W && co0 + c < Cout;
        cp_async16(&dys[buf][p * KS + c], ok ? dyrow + (size_t)(w0 + p) * Cout + co0 + c : dy, ok);
      }
    } else {
      for (int i = tid; i < XQ * CI_T; i += THREADS) {
        const int q = i / CI_T, c = i % CI_T;
        const int gx = reflect_index(w0 - 1 + q, W);
        xs[buf][q * KS + c] = ci0 + c < Cin ? xrow[(size_t)gx * Cin + ci0 + c] : zero;
      }
      for (int i = tid; i < SEG * CO_T; i += THREADS) {
        const int p = i / CO_T, c = i % CO_T;
        dys[buf][p * KS + c] = (w0 + p < W && co0 + c < Cout)
                                   ? dyrow[(size_t)(w0 + p) * Cout + co0 + c] : zero;
      }
    }
  };

  if (lo < hi) stage(lo, 0);
  cp_async_commit();
  for (long long seg = lo; seg < hi; ++seg) {
    const int buf = (int)((seg - lo) & 1);
    if (seg + 1 < hi) stage(seg + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();   // this segment's copies have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SEG / 16; ++kk) {
      // B[k][n] = dy[pixel kk*16 + k][co wn*32 + n]: n-tiles (0, 1), (2, 3)
      uint32_t b[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4_trans(r, &dys[buf][(kk * 16 + lk + lr) * KS + wn * 32 + jp * 16 + lm]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A[m][k] = x[pixel kk*16 + k + kx - 1 of the row][ci wm*16 + m]
        uint32_t a[4];
        ldsm_x4_trans(a, &xs[buf][(kk * 16 + kx + lm + lr) * KS + wm * 16 + lk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[kx][j], a, b[j][0], b[j][1]);
      }
    }
    __syncthreads();   // the buffer is refilled next iteration
  }

  // C fragment: c0, c1 at ci row g, co columns 2t, 2t+1; c2, c3 at row g + 8
  float* ps = part + (size_t)s * 9 * Cin * Cout;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = ci0 + wm * 16 + g + (r >= 2 ? 8 : 0);
        const int co = co0 + wn * 32 + j * 8 + 2 * t + (r & 1);
        if (ci < Cin && co < Cout)
          ps[((size_t)(ky * 3 + kx) * Cin + ci) * Cout + co] = acc[kx][j][r];
      }
}

// ---------------------------------------------------------------------------

__global__ void dw_reduce(const float* __restrict__ part, float* __restrict__ dw,
                          long long count, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[(size_t)s * count + i];
  dw[i] = v;
}

}  // namespace

// x (N,H,W,Cin), dy (N,H,W,Cout) in one dtype (0 = float32, 1 = bfloat16);
// part: float32 scratch of S * 9 * Cin * Cout; dw (3,3,Cin,Cout) float32.
// Returns cudaGetLastError() after the two launches (0 = cudaSuccess); both
// are asynchronous on `stream`.
extern "C" int reflect_conv3x3_dw(const void* x, const void* dy, void* part,
                                  void* dw, int N, int H, int W, int Cin,
                                  int Cout, int S, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Cin + CI_T - 1) / CI_T, (Cout + CO_T - 1) / CO_T, 3 * S);
  float* p = static_cast<float*>(part);
  if (dtype == 0) {
    dw_partial_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), p, N, H, W, Cin, Cout, S);
  } else if (dtype == 1) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
    const int vec = (Cin % 8 == 0 && Cout % 8 == 0 && aligned) ? 1 : 0;
    dw_partial_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), p, N, H,
        W, Cin, Cout, S, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long count = 9LL * Cin * Cout;
  dw_reduce<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(p, static_cast<float*>(dw), count, S);
  return static_cast<int>(cudaGetLastError());
}
