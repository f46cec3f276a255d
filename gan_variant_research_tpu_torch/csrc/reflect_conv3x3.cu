// Reflect-pad(1) + 3x3 valid convolution + bias, NHWC, for Hopper (sm_90a).
//
// Replaces gan_variant_research_tpu/ops/pallas/resblock.py::_fwd_pallas
// (body _fwd_kernel, helpers _store_reflect_pad and _chunked_conv): the
// residual trunk's conv, 18 calls per ResNet-9 forward at (B, 64, 64, 256).
//
// Contract (the same as the TPU kernel's):
//   x (N, H, W, Cin) float32 or bfloat16, NHWC contiguous, H >= 2, W >= 2;
//   w (3, 3, Cin, Cout) HWIO contiguous, in x's dtype;
//   b (Cout,) float32;
//   y (N, H, W, Cout) in x's dtype = cast(sum_{ky,kx,ci} xr * w + b), where
//   xr is x reflected at the border (row -1 -> 1, row H -> H-2, the same for
//   columns). Products and sums are float32; the bias is added in float32
//   before the single cast to the output dtype. No padded tensor is written.
//
// What bounds it. At B = 32 one trunk conv is 2*9*32*64*64*256*256 ~= 154.6
// GFLOP against ~134 MB of bf16 activations read and written (x and y, each
// 32*64*64*256*2 bytes): about 1150 FLOP per byte, far above the H100's ~295
// FLOP/byte ridge for bf16. The conv is compute-bound, and only the tensor
// cores (wgmma) would make it fast.
//
// What this design does about that. Two kernels, picked by dtype; both are
// the simple, exact first versions (one shared-memory stage, no pipelining):
//   - bf16: tensor cores through mma.sync m16n8k16 (bf16 products, float32
//     accumulation), an implicit GEMM with M = output pixels, N = output
//     channels, K = 9 taps x Cin. One block (8 warps) owns a 16x16 output
//     tile of one sample and 64 output channels; each warp owns two output
//     rows (two m16 tiles) x 64 channels (eight n8 tiles). Cin is walked in
//     chunks of 16 (one mma k-step per tap): the block stages the reflected
//     18x18 halo and the weight slice, transposed to [tap][co][ci], in
//     shared memory with a padded 48-byte pixel stride, so every fragment
//     load is one conflict-free 32-bit read.
//   - float32: plain FP32 FMA on the CUDA cores (TF32 would break the exact
//     float32 contract). One block owns an 8x16 output tile and 64 output
//     channels; each thread keeps 8 pixels x 4 channels of accumulators and
//     reads, per (ci, ky), 10 halo values and 3 float4 weight vectors from
//     shared memory for 96 FMAs. The halo's channel stride is padded
//     (KC + 1) so the two pixel groups of a warp hit different banks.
// In both, the reflect is done on the index while staging, so the padded
// plane never exists in memory. wgmma, TMA and a multi-stage pipeline are
// the next versions' work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 16;         // output columns per block
constexpr int CO_T = 64;       // output channels per block
constexpr int KC = 16;         // input channels per shared-memory chunk
constexpr int KCP = KC + 1;    // padded channel stride of the halo
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int PX = 8;          // output columns per thread
constexpr int CV = 4;          // output channels per thread
constexpr int CGROUPS = CO_T / CV;               // 16
constexpr int PGROUPS = (TH * TW) / PX;          // 16
constexpr int THREADS = CGROUPS * PGROUPS;       // 256

// Reflect an index in [-1, n] into [0, n). Halo rows and columns past a
// ragged tile's edge only feed masked outputs; the clamp keeps their reads
// inside the tensor.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(THREADS)
reflect_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float xs[HALO_H * HALO_W * KCP];          // [hy][hx][ci]
  __shared__ __align__(16) float ws[9 * KC * CO_T];    // [tap][ci][co]

  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO_T;
  const int tid = threadIdx.x;
  const int cg = tid % CGROUPS;
  const int pg = tid / CGROUPS;
  const int row = pg / (TW / PX);
  const int col0 = (pg % (TW / PX)) * PX;

  float acc[PX][CV];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[p][c] = 0.f;

  const float* xn = x + (size_t)n * H * W * Cin;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    // Stage the reflected halo: consecutive threads read consecutive
    // channels of one pixel.
    for (int i = tid; i < HALO_H * HALO_W * KC; i += THREADS) {
      const int ci = i % KC;
      const int pix = i / KC;
      const int hx = pix % HALO_W;
      const int hy = pix / HALO_W;
      const int gy = reflect_index(ty0 - 1 + hy, H);
      const int gx = reflect_index(tx0 - 1 + hx, W);
      float v = 0.f;
      if (c0 + ci < Cin) v = xn[((size_t)gy * W + gx) * Cin + c0 + ci];
      xs[pix * KCP + ci] = v;
    }
    // Stage the weight slice: consecutive threads read consecutive output
    // channels. Channels past Cin or Cout are zero, so they add nothing.
    for (int i = tid; i < 9 * KC * CO_T; i += THREADS) {
      const int co = i % CO_T;
      const int r = i / CO_T;
      const int ci = r % KC;
      const int tap = r / KC;
      float v = 0.f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co];
      ws[i] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < KC; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* xr = xs + ((row + ky) * HALO_W + col0) * KCP + ci;
        float xv[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xv[j] = xr[j * KCP];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + ((ky * 3 + kx) * KC + ci) * CO_T + cg * CV);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xp = xv[p + kx];
            acc[p][0] = fmaf(xp, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xp, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xp, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xp, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + row;
  if (oy >= H) return;
  float bv[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    const int co = co0 + cg * CV + c;
    bv[c] = co < Cout ? bias[co] : 0.f;
  }
  float* yr = y + ((size_t)n * H + oy) * W * Cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = tx0 + col0 + p;
    if (ox >= W) break;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int co = co0 + cg * CV + c;
      if (co < Cout) yr[(size_t)ox * Cout + co] = acc[p][c] + bv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 implicit GEMM

constexpr int M_TH = 16;                 // output rows per block
constexpr int M_TW = 16;                 // output columns per block (= m16)
constexpr int M_CO = 64;                 // output channels per block
constexpr int M_KC = 16;                 // input channels per chunk (= k16)
constexpr int M_KP = 24;                 // padded bf16 stride of a pixel / weight row
constexpr int M_HH = M_TH + 2;
constexpr int M_HW = M_TW + 2;
constexpr int M_ROWS_PER_WARP = 2;
constexpr int M_NT = M_CO / 8;           // n8 tiles per warp
constexpr int M_THREADS = 32 * (M_TH / M_ROWS_PER_WARP);   // 256

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// vec: Cin and Cout are multiples of 8 and x, w, y are 16-byte aligned, so
// staging moves 8 channels per 16-byte load and the epilogue stores pairs.
__global__ void __launch_bounds__(M_THREADS)
reflect_conv3x3_bf16(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
                     int Cout, int tiles_w, int vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[M_HH * M_HW * M_KP];   // [hy][hx][ci]
  __shared__ __align__(16) __nv_bfloat16 ws[9 * M_CO * M_KP];      // [tap][co][ci]

  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * M_TH;
  const int tx0 = (blockIdx.x % tiles_w) * M_TW;
  const int co0 = blockIdx.y * M_CO;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;       // fragment row group
  const int t = lane & 3;        // thread in group
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  float acc[M_ROWS_PER_WARP][M_NT][4];
#pragma unroll
  for (int m = 0; m < M_ROWS_PER_WARP; ++m)
#pragma unroll
    for (int j = 0; j < M_NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][j][r] = 0.f;

  const __nv_bfloat16* xn = x + (size_t)n * H * W * Cin;

  for (int c0 = 0; c0 < Cin; c0 += M_KC) {
    if (vec) {
      // halo: one 16-byte vector = 8 channels of one pixel
      for (int i = tid; i < M_HH * M_HW * (M_KC / 8); i += M_THREADS) {
        const int half = i % (M_KC / 8);
        const int pix = i / (M_KC / 8);
        const int gy = reflect_index(ty0 - 1 + pix / M_HW, H);
        const int gx = reflect_index(tx0 - 1 + pix % M_HW, W);
        const int ci = c0 + half * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ci < Cin)
          v = *reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * Cin + ci);
        *reinterpret_cast<uint4*>(xs + pix * M_KP + half * 8) = v;
      }
      // weights: 8 output channels per vector, transposed into [tap][co][ci]
      for (int i = tid; i < 9 * M_KC * (M_CO / 8); i += M_THREADS) {
        const int cv = i % (M_CO / 8);
        const int r = i / (M_CO / 8);
        const int ci = r % M_KC;
        const int tap = r / M_KC;
        const int co = co0 + cv * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c0 + ci < Cin && co < Cout)
          v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + c0 + ci) * Cout + co);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) ws[(tap * M_CO + cv * 8 + k) * M_KP + ci] = e[k];
      }
    } else {
      for (int i = tid; i < M_HH * M_HW * M_KC; i += M_THREADS) {
        const int ci = i % M_KC;
        const int pix = i / M_KC;
        const int gy = reflect_index(ty0 - 1 + pix / M_HW, H);
        const int gx = reflect_index(tx0 - 1 + pix % M_HW, W);
        xs[pix * M_KP + ci] =
            c0 + ci < Cin ? xn[((size_t)gy * W + gx) * Cin + c0 + ci] : zero;
      }
      for (int i = tid; i < 9 * M_KC * M_CO; i += M_THREADS) {
        const int co = i % M_CO;
        const int r = i / M_CO;
        const int ci = r % M_KC;
        const int tap = r / M_KC;
        ws[(tap * M_CO + co) * M_KP + ci] =
            (c0 + ci < Cin && co0 + co < Cout)
                ? w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
      uint32_t a[M_ROWS_PER_WARP][4];
#pragma unroll
      for (int m = 0; m < M_ROWS_PER_WARP; ++m) {
        // A[px][k] = halo[row + ky][px + kx][k]
        const __nv_bfloat16* base =
            xs + ((warp * M_ROWS_PER_WARP + m + ky) * M_HW + kx) * M_KP + 2 * t;
        a[m][0] = lds32(base + g * M_KP);
        a[m][1] = lds32(base + (g + 8) * M_KP);
        a[m][2] = lds32(base + g * M_KP + 8);
        a[m][3] = lds32(base + (g + 8) * M_KP + 8);
      }
#pragma unroll
      for (int j = 0; j < M_NT; ++j) {
        // B[k][co] = ws[tap][co][k]
        const __nv_bfloat16* wb = ws + (tap * M_CO + j * 8 + g) * M_KP + 2 * t;
        const uint32_t b0 = lds32(wb);
        const uint32_t b1 = lds32(wb + 8);
#pragma unroll
        for (int m = 0; m < M_ROWS_PER_WARP; ++m) mma_bf16(acc[m][j], a[m], b0, b1);
      }
    }
    __syncthreads();
  }

  // D fragment: d[0], d[1] at pixel g, channels 2t, 2t+1; d[2], d[3] at
  // pixel g + 8.
#pragma unroll
  for (int m = 0; m < M_ROWS_PER_WARP; ++m) {
    const int oy = ty0 + warp * M_ROWS_PER_WARP + m;
    if (oy >= H) continue;
    __nv_bfloat16* yr = y + ((size_t)n * H + oy) * W * Cout;
#pragma unroll
    for (int j = 0; j < M_NT; ++j) {
      const int co = co0 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = tx0 + g + 8 * h;
        if (ox >= W) continue;
        __nv_bfloat16* dst = yr + (size_t)ox * Cout + co;
        if (vec && co < Cout) {   // Cout % 8 == 0, so co + 1 < Cout too
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              acc[m][j][2 * h] + bias[co], acc[m][j][2 * h + 1] + bias[co + 1]);
        } else {
          if (co < Cout) dst[0] = __float2bfloat16_rn(acc[m][j][2 * h] + bias[co]);
          if (co + 1 < Cout) dst[1] = __float2bfloat16_rn(acc[m][j][2 * h + 1] + bias[co + 1]);
        }
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int reflect_conv3x3_forward(const void* x, const void* w,
                                       const void* b, void* y, int N, int H,
                                       int W, int Cin, int Cout, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int tiles_w = (W + TW - 1) / TW;
    const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Cout + CO_T - 1) / CO_T, N);
    reflect_conv3x3_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), H, W, Cin, Cout,
        tiles_w);
  } else if (dtype == 1) {
    const int tiles_w = (W + M_TW - 1) / M_TW;
    const dim3 grid(((H + M_TH - 1) / M_TH) * tiles_w, (Cout + M_CO - 1) / M_CO, N);
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(y)) % 16) == 0;
    const int vec = (Cin % 8 == 0 && Cout % 8 == 0 && aligned) ? 1 : 0;
    reflect_conv3x3_bf16<<<grid, M_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), H, W, Cin,
        Cout, tiles_w, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
