// Input gradient of reflect-pad(1) + 3x3 conv, NHWC, for Hopper (sm_90a).
//
// Replaces gan_variant_research_tpu/ops/pallas/resblock.py::_dx_pallas
// (body _dx_kernel, helpers _store_zero_pad2 and _fold_reflect_vals): the
// backward of every residual-trunk conv, 18 per ResNet-9 pass at
// (B, 64, 64, 256).
//
// Contract:
//   dy (N, H, W, Cout) float32 or bfloat16, NHWC contiguous, H >= 2, W >= 2;
//   wf (3, 3, Cout, Cin) in dy's dtype: the forward's HWIO kernel flipped in
//      both spatial axes with its channel axes swapped (the wrapper makes it);
//   dx (N, H, W, Cin) in dy's dtype = cast(fold(dxp)), where
//      dxp (N, H+2, W+2, Cin) = full correlation of the zero-padded dy with wf
//      is the gradient of the reflect-padded input, and fold adds its border
//      rows and columns onto their reflection sources (padded row 0 onto row
//      1, padded row H+1 onto row H-2, the same for columns). Products, sums
//      and the fold are float32; there is one cast at the end.
//   The TPU kernel stages dxp in dy's dtype before the fold, so in bf16 it
//   rounds the border rows and columns twice; this kernel rounds once. The
//   two differ by up to about two bf16 ulps on the two border rows and
//   columns, and agree to one ulp elsewhere. The TPU fold also breaks for H
//   or W of 2 or 3, where its fold targets coincide; here they simply add.
//
// What bounds it. The interior is the forward conv with other weights: at
// B = 12, 2*9*12*64*64*256*256 ~= 58 GFLOP against ~50 MB of bf16 read and
// written, compute-bound on the tensor cores. The fold touches only the
// padded frame, 2(W+2) + 2H of the (H+2)(W+2) positions, with at most three
// taps each: ~1.2 GFLOP.
//
// What this design does about that. Two launches on one stream:
//   1. dx_frame: the padded frame of dxp (rows 0 and H+1, columns 0 and
//      W+1), float32, into a small scratch buffer (N, 2(W+2)+2H, Cin). Each
//      side of the frame is a 1-D correlation of one dy line with one kernel
//      row or column; a block owns 8 positions of a side and 256 input
//      channels, so each weight it reads serves 8 positions. FP32 FMA: this
//      pass is ~2% of the FLOPs.
//   2. the main pass: dxp at the interior positions, i.e. the zero-padded
//      "same" 3x3 conv of dy with wf, in the forward kernel's two shapes
//      (bf16: mma.sync m16n8k16 with float32 accumulation, 16x16 pixels x
//      64 channels a block; float32: FMA, never TF32, 8x16 pixels x 64
//      channels). Its epilogue adds the frame values that fold onto a pixel,
//      in float32, before the one cast. So the (H+2) x (W+2) padded gradient
//      never reaches device memory, only its frame.
// Ragged H, W, Cin, Cout are masked. wgmma, TMA and pipelining come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The fold of the frame onto dx pixel (i, j), channel c. fr is one sample's
// frame: [top row q = 0..W+1][bottom row q = 0..W+1][left column p = 1..H]
// [right column p = 1..H], each position Cin channels.
__device__ __forceinline__ float frame_fold(const float* __restrict__ fr, int H,
                                            int W, int C, int i, int j, int c) {
  const int top = 0, bot = W + 2, left = 2 * (W + 2), right = 2 * (W + 2) + H;
  float v = 0.f;
  if (j == 1) v += fr[(size_t)(left + i) * C + c];
  if (j == W - 2) v += fr[(size_t)(right + i) * C + c];
  if (i == 1) {
    float r = fr[(size_t)(top + j + 1) * C + c];
    if (j == 1) r += fr[(size_t)top * C + c];
    if (j == W - 2) r += fr[(size_t)(top + W + 1) * C + c];
    v += r;
  }
  if (i == H - 2) {
    float r = fr[(size_t)(bot + j + 1) * C + c];
    if (j == 1) r += fr[(size_t)bot * C + c];
    if (j == W - 2) r += fr[(size_t)(bot + W + 1) * C + c];
    v += r;
  }
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// 1. the padded frame of dxp

constexpr int FR_THREADS = 256;   // input channels per block
constexpr int FR_SEG = 8;         // frame positions per block
constexpr int FR_CO = 32;         // dy channels staged per round

// The frame is four lines, each a 1-D correlation of one dy line with one
// row or column of the kernel:
//   line 0, padded row 0:      dxp[0][q]   = sum_kx dy[0][q-kx]   . w[0][kx]
//   line 1, padded row H+1:    dxp[H+1][q] = sum_kx dy[H-1][q-kx] . w[2][kx]
//   line 2, padded column 0:   dxp[p][0]   = sum_ky dy[p-ky][0]   . w[ky][0]
//   line 3, padded column W+1: dxp[p][W+1] = sum_ky dy[p-ky][W-1] . w[ky][2]
// (q = 0..W+1, p = 1..H; dy is 0 outside the image). A block owns FR_SEG
// positions of one line and 256 input channels, one per thread; each weight
// it reads (coalesced along Cin) serves its FR_SEG positions, and the dy
// values (FR_SEG + 2 per channel) are staged in shared memory. w[ky][kx][ci]
// [co] = wf[2-ky][2-kx][co][ci].
template <typename T>
__global__ void __launch_bounds__(FR_THREADS)
dx_frame(const T* __restrict__ dy, const T* __restrict__ wf,
         float* __restrict__ frame, int H, int W, int Cin, int Cout) {
  __shared__ float dys[FR_SEG + 2][FR_CO];
  const int segs_row = (W + 2 + FR_SEG - 1) / FR_SEG;
  const int segs_col = (H + FR_SEG - 1) / FR_SEG;
  int b = blockIdx.x, line;
  if (b < 2 * segs_row) {
    line = b / segs_row;
    b %= segs_row;
  } else {
    b -= 2 * segs_row;
    line = 2 + b / segs_col;
    b %= segs_col;
  }
  const bool is_row = line < 2;
  const int len = is_row ? W + 2 : H;         // positions on the line
  const int dlen = is_row ? W : H;            // its dy line
  const int off = is_row ? 0 : 1;             // dy index = j + off - k
  const int fixed = (line % 2) ? 2 : 0;       // the kernel row or column
  const int base = is_row ? line * (W + 2) : 2 * (W + 2) + (line - 2) * H;
  const int j0 = b * FR_SEG;
  const int n = blockIdx.y;
  const int ci = blockIdx.z * FR_THREADS + threadIdx.x;
  const T* dyn = dy + (size_t)n * H * W * Cout;
  // the dy line: row 0 or H-1, or column 0 or W-1
  const int dfix = (line % 2) ? (is_row ? H - 1 : W - 1) : 0;

  float acc[FR_SEG];
#pragma unroll
  for (int i = 0; i < FR_SEG; ++i) acc[i] = 0.f;

  for (int co0 = 0; co0 < Cout; co0 += FR_CO) {
    for (int i = threadIdx.x; i < (FR_SEG + 2) * FR_CO; i += FR_THREADS) {
      const int u = i / FR_CO, c = i % FR_CO;
      const int d = j0 + off - 2 + u;          // index along the dy line
      float v = 0.f;
      if (d >= 0 && d < dlen && co0 + c < Cout) {
        const int y = is_row ? dfix : d, x = is_row ? d : dfix;
        v = to_f(dyn[((size_t)y * W + x) * Cout + co0 + c]);
      }
      dys[u][c] = v;
    }
    __syncthreads();
    if (ci < Cin) {
      const int cend = min(FR_CO, Cout - co0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ky = is_row ? fixed : k, kx = is_row ? k : fixed;
        const T* wt = wf + ((size_t)((2 - ky) * 3 + (2 - kx)) * Cout + co0) * Cin + ci;
#pragma unroll 8
        for (int c = 0; c < cend; ++c) {
          const float wv = to_f(wt[(size_t)c * Cin]);
#pragma unroll
          for (int i = 0; i < FR_SEG; ++i) acc[i] = fmaf(dys[i + 2 - k][c], wv, acc[i]);
        }
      }
    }
    __syncthreads();
  }
  if (ci >= Cin) return;
  float* fr = frame + ((size_t)n * (2 * (W + 2) + 2 * H) + base) * Cin + ci;
#pragma unroll
  for (int i = 0; i < FR_SEG; ++i)
    if (j0 + i < len) fr[(size_t)(j0 + i) * Cin] = acc[i];
}

// ---------------------------------------------------------------------------
// 2. the interior, float32 on FMA. Here "x" is dy (Cin_k = Cout channels)
// and "y" is dx (Cout_k = Cin channels).

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int CO_T = 64;
constexpr int KC = 16;
constexpr int KCP = KC + 1;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int PX = 8;
constexpr int CV = 4;
constexpr int CGROUPS = CO_T / CV;
constexpr int PGROUPS = (TH * TW) / PX;
constexpr int THREADS = CGROUPS * PGROUPS;

__global__ void __launch_bounds__(THREADS)
dx_main_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ frame, float* __restrict__ y,
            int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float xs[HALO_H * HALO_W * KCP];
  __shared__ __align__(16) float ws[9 * KC * CO_T];

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
    // zero-padded halo: positions outside the image are 0
    for (int i = tid; i < HALO_H * HALO_W * KC; i += THREADS) {
      const int ci = i % KC;
      const int pix = i / KC;
      const int gy = ty0 - 1 + pix / HALO_W;
      const int gx = tx0 - 1 + pix % HALO_W;
      float v = 0.f;
      if (c0 + ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xn[((size_t)gy * W + gx) * Cin + c0 + ci];
      xs[pix * KCP + ci] = v;
    }
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
  const float* fr = frame + (size_t)n * (2 * (W + 2) + 2 * H) * Cout;
  float* yr = y + ((size_t)n * H + oy) * W * Cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = tx0 + col0 + p;
    if (ox >= W) break;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int co = co0 + cg * CV + c;
      if (co < Cout) yr[(size_t)ox * Cout + co] = acc[p][c] + frame_fold(fr, H, W, Cout, oy, ox, co);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the interior, bf16 on mma.sync m16n8k16 (the forward kernel's layout)

constexpr int M_TH = 16;
constexpr int M_TW = 16;
constexpr int M_CO = 64;
constexpr int M_KC = 16;
constexpr int M_KP = 24;
constexpr int M_HH = M_TH + 2;
constexpr int M_HW = M_TW + 2;
constexpr int M_ROWS_PER_WARP = 2;
constexpr int M_NT = M_CO / 8;
constexpr int M_THREADS = 32 * (M_TH / M_ROWS_PER_WARP);

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

// Two blocks an SM, as the forward kernel gets (126 registers): the fold in
// the epilogue would otherwise take the register count to 178 and one block.
__global__ void __launch_bounds__(M_THREADS, 2)
dx_main_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ frame,
             __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
             int Cout, int tiles_w, int vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[M_HH * M_HW * M_KP];
  __shared__ __align__(16) __nv_bfloat16 ws[9 * M_CO * M_KP];

  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * M_TH;
  const int tx0 = (blockIdx.x % tiles_w) * M_TW;
  const int co0 = blockIdx.y * M_CO;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
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
      for (int i = tid; i < M_HH * M_HW * (M_KC / 8); i += M_THREADS) {
        const int half = i % (M_KC / 8);
        const int pix = i / (M_KC / 8);
        const int gy = ty0 - 1 + pix / M_HW;
        const int gx = tx0 - 1 + pix % M_HW;
        const int ci = c0 + half * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = *reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * Cin + ci);
        *reinterpret_cast<uint4*>(xs + pix * M_KP + half * 8) = v;
      }
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
        const int gy = ty0 - 1 + pix / M_HW;
        const int gx = tx0 - 1 + pix % M_HW;
        xs[pix * M_KP + ci] =
            (c0 + ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
                ? xn[((size_t)gy * W + gx) * Cin + c0 + ci] : zero;
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
        const __nv_bfloat16* base =
            xs + ((warp * M_ROWS_PER_WARP + m + ky) * M_HW + kx) * M_KP + 2 * t;
        a[m][0] = lds32(base + g * M_KP);
        a[m][1] = lds32(base + (g + 8) * M_KP);
        a[m][2] = lds32(base + g * M_KP + 8);
        a[m][3] = lds32(base + (g + 8) * M_KP + 8);
      }
#pragma unroll
      for (int j = 0; j < M_NT; ++j) {
        const __nv_bfloat16* wb = ws + (tap * M_CO + j * 8 + g) * M_KP + 2 * t;
        const uint32_t b0 = lds32(wb);
        const uint32_t b1 = lds32(wb + 8);
#pragma unroll
        for (int m = 0; m < M_ROWS_PER_WARP; ++m) mma_bf16(acc[m][j], a[m], b0, b1);
      }
    }
    __syncthreads();
  }

  const float* fr = frame + (size_t)n * (2 * (W + 2) + 2 * H) * Cout;
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
        float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (oy <= 1 || oy >= H - 2 || ox <= 1 || ox >= W - 2) {
          if (co < Cout) v0 += frame_fold(fr, H, W, Cout, oy, ox, co);
          if (co + 1 < Cout) v1 += frame_fold(fr, H, W, Cout, oy, ox, co + 1);
        }
        if (vec && co < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Cout) dst[0] = __float2bfloat16_rn(v0);
          if (co + 1 < Cout) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

}  // namespace

// dy (N,H,W,Cout), wf (3,3,Cout,Cin), frame float32 scratch of
// N * (2(W+2) + 2H) * Cin, dx (N,H,W,Cin). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the two launches (0 = cudaSuccess); both
// are asynchronous on `stream`.
extern "C" int reflect_conv3x3_dx(const void* dy, const void* wf, void* frame,
                                  void* dx, int N, int H, int W, int Cin,
                                  int Cout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int frame_segs = 2 * ((W + 2 + FR_SEG - 1) / FR_SEG) + 2 * ((H + FR_SEG - 1) / FR_SEG);
  const dim3 fgrid(frame_segs, N, (Cin + FR_THREADS - 1) / FR_THREADS);
  float* fr = static_cast<float*>(frame);
  if (dtype == 0) {
    dx_frame<float><<<fgrid, FR_THREADS, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(wf), fr, H, W, Cin, Cout);
    const int tiles_w = (W + TW - 1) / TW;
    const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Cin + CO_T - 1) / CO_T, N);
    dx_main_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(wf), fr,
        static_cast<float*>(dx), H, W, Cout, Cin, tiles_w);
  } else if (dtype == 1) {
    dx_frame<__nv_bfloat16><<<fgrid, FR_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(wf), fr,
        H, W, Cin, Cout);
    const int tiles_w = (W + M_TW - 1) / M_TW;
    const dim3 grid(((H + M_TH - 1) / M_TH) * tiles_w, (Cin + M_CO - 1) / M_CO, N);
    const bool aligned = ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(wf) |
                           reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
    const int vec = (Cin % 8 == 0 && Cout % 8 == 0 && aligned) ? 1 : 0;
    dx_main_bf16<<<grid, M_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(wf), fr,
        static_cast<__nv_bfloat16*>(dx), H, W, Cout, Cin, tiles_w, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
