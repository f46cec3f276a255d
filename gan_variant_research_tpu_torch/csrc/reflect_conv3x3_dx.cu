// Input gradient of reflect-pad(1) + 3x3 conv, NHWC, for Hopper (sm_90a).
//
// Replaces gan_variant_research_tpu/ops/pallas/resblock.py::_dx_pallas
// (body _dx_kernel, helpers _store_zero_pad2 and _fold_reflect_vals): the
// backward of every residual-trunk conv, 18 per ResNet-9 pass at
// (B, 64, 64, 256).
//
// Contract:
//   dy (N, H, W, Cout) float32 or bfloat16, NHWC contiguous, H >= 2, W >= 2;
//   dx (N, H, W, Cin) in dy's dtype = cast(fold(dxp)), where
//      dxp (N, H+2, W+2, Cin) = full correlation of the zero-padded dy with
//      the forward's HWIO kernel w (3, 3, Cin, Cout) flipped in both spatial
//      axes, is the gradient of the reflect-padded input, and fold adds its
//      border rows and columns onto their reflection sources (padded row 0
//      onto row 1, padded row H+1 onto row H-2, the same for columns).
//      Products, sums and the fold are float32; there is one cast at the end.
//   The TPU kernel stages dxp in dy's dtype before the fold, so in bf16 it
//   rounds the border rows and columns twice; this kernel rounds once. The
//   two differ by up to about two bf16 ulps on the two border rows and
//   columns, and agree to one ulp elsewhere. The TPU fold also breaks for H
//   or W of 2 or 3, where its fold targets coincide; here they simply add.
//
// What bounds it. The interior is an implicit GEMM: M = N*H*W pixels, N =
// Cin, K = 9 taps x Cout. At B = 12, 2*9*12*64*64*256*256 ~= 58 GFLOP
// against ~50 MB of bf16 read and written: operation-bound on the tensor
// cores (0.059 ms at 989 TFLOP/s). The fold touches only the padded frame,
// 2(W+2) + 2H of the (H+2)(W+2) positions, with three taps each: ~1.2 GFLOP.
//
// The frame pass writes the padded frame of dxp (rows 0 and H+1, columns 0
// and W+1) in float32 to a scratch buffer (N, 2(W+2) + 2H, Cin); the main
// pass computes dxp at the interior positions (the zero-padded "same" conv
// of dy with the flipped kernel), and the frame values that fold onto a
// pixel are added in float32 before the one cast. The (H+2) x (W+2) padded
// gradient never reaches device memory. The caller picks one of two routes
// (the `route` argument), each launched on one stream:
//
//   0  float32: FMA, never TF32; frame pass, then the main pass with the fold
//      in its epilogue. Both take the kernel flipped and with its channel
//      axes swapped, wf (3, 3, Cout, Cin).
//   1  bf16 on wgmma, for Cin and Cout multiples of 8 and 16-byte aligned
//      pointers (the caller zero-pads other channel counts); it takes w
//      (3, 3, Cin, Cout) as it is. Three launches: dx_frame_mma,
//      dx_main_wgmma, dx_fold.
//
// Route 1's main pass is an implicit GEMM, persistent: one block per SM walks
// the tiles of 128 pixels (two image rows of 64) x 256 input channels, so
// that its ring fills the next tile while the last one's epilogue stores. One
// producer warpgroup (40 registers by setmaxnreg), one thread of which issues
// every TMA load, fills a ring of four K-stages on full and empty mbarriers;
// a K-stage is one tap and 64 dy channels: A (128 pixels x 64 channels, 16
// KB) by a 4-D tensor map over dy (Cout, W, H, N), its box shifted by the
// tap, so that TMA's zero fill of what lies outside the image is the zero
// padding; B (256 input channels x 64 dy channels, 32 KB) by a 3-D map over w
// (Cout, Cin, 9) at tap 8 - t (the spatial flip). Both are K-major rows of
// 128 bytes in the 128-byte swizzle. Two consumer warpgroups (232 registers),
// one image row each, run wgmma.m64n256k16 from shared memory into a 64 x 256
// float32 accumulator (128 registers a thread), keep one stage's products in
// flight while they release the one before, and only store: bf16 straight
// from the accumulator, or, for the pixels the fold reaches (rows 1 and H-2,
// columns 1 and W-2), the float32 sum to scratch, which dx_fold adds to the
// frame and casts. dy is read once per tap. At (12, 64, 64, 256) the K loop
// alone runs at ~930 TFLOP/s; the epilogue's stores, the last of 2.9 tiles a
// block and the two small passes are the rest. L2 traffic does not bound it:
// a 2-block cluster sharing B by TMA multicast gained nothing. The frame pass
// runs on mma.sync: a block owns one frame line of one image, 64 input
// channels and up to 128 positions, so each weight it stages serves the whole
// line.
// No atomics: every route gives the same bits from run to run.

#include <cuda.h>   // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// The fold of the frame onto dx pixel (i, j), channel c. fr is one sample's
// frame: [top row q = 0..W+1][bottom row q = 0..W+1][left column p = 1..H]
// [right column p = 1..H], each position C channels.
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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
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

// The frame is four lines, each a 1-D correlation of one dy line with one
// row or column of the kernel:
//   line 0, padded row 0:      dxp[0][q]   = sum_kx dy[0][q-kx]   . w[0][kx]
//   line 1, padded row H+1:    dxp[H+1][q] = sum_kx dy[H-1][q-kx] . w[2][kx]
//   line 2, padded column 0:   dxp[p][0]   = sum_ky dy[p-ky][0]   . w[ky][0]
//   line 3, padded column W+1: dxp[p][W+1] = sum_ky dy[p-ky][W-1] . w[ky][2]
// (q = 0..W+1, p = 1..H; dy is 0 outside the image; w[ky][kx] the forward's
// HWIO kernel, a (Cin, Cout) matrix). Position u of a line (q = u, p = u + 1)
// takes dy line index u + off - k for tap k, off = 0 on rows, 1 on columns.
struct FrameLine {
  int len;     // positions on the line
  int dlen;    // length of its dy line
  int off;
  int fixed;   // the kernel row (row lines) or column (column lines)
  int dfix;    // the dy row or column
  int base;    // first position of the line in the frame buffer
  bool is_row;
};

__device__ __forceinline__ FrameLine frame_line(int line, int H, int W) {
  FrameLine l;
  l.is_row = line < 2;
  l.len = l.is_row ? W + 2 : H;
  l.dlen = l.is_row ? W : H;
  l.off = l.is_row ? 0 : 1;
  l.fixed = (line & 1) ? 2 : 0;
  l.dfix = (line & 1) ? (l.is_row ? H - 1 : W - 1) : 0;
  l.base = l.is_row ? line * (W + 2) : 2 * (W + 2) + (line - 2) * H;
  return l;
}

// ---------------------------------------------------------------------------
// Route 0: the frame on FMA. A block owns FR_SEG positions of one line
// and 256 input channels, one per thread; each weight it reads (coalesced
// along Cin) serves its FR_SEG positions, and the dy values (FR_SEG + 2 per
// channel) are staged in shared memory. w[ky][kx][ci][co] = wf[2-ky][2-kx]
// [co][ci].

constexpr int FR_THREADS = 256;   // input channels per block
constexpr int FR_SEG = 8;         // frame positions per block
constexpr int FR_CO = 32;         // dy channels staged per round

__global__ void __launch_bounds__(FR_THREADS)
dx_frame(const float* __restrict__ dy, const float* __restrict__ wf,
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
  const FrameLine l = frame_line(line, H, W);
  const int j0 = b * FR_SEG;
  const int n = blockIdx.y;
  const int ci = blockIdx.z * FR_THREADS + threadIdx.x;
  const float* dyn = dy + (size_t)n * H * W * Cout;

  float acc[FR_SEG];
#pragma unroll
  for (int i = 0; i < FR_SEG; ++i) acc[i] = 0.f;

  for (int co0 = 0; co0 < Cout; co0 += FR_CO) {
    for (int i = threadIdx.x; i < (FR_SEG + 2) * FR_CO; i += FR_THREADS) {
      const int u = i / FR_CO, c = i % FR_CO;
      const int d = j0 + l.off - 2 + u;          // index along the dy line
      float v = 0.f;
      if (d >= 0 && d < l.dlen && co0 + c < Cout) {
        const int y = l.is_row ? l.dfix : d, x = l.is_row ? d : l.dfix;
        v = dyn[((size_t)y * W + x) * Cout + co0 + c];
      }
      dys[u][c] = v;
    }
    __syncthreads();
    if (ci < Cin) {
      const int cend = min(FR_CO, Cout - co0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ky = l.is_row ? l.fixed : k, kx = l.is_row ? k : l.fixed;
        const float* wt = wf + ((size_t)((2 - ky) * 3 + (2 - kx)) * Cout + co0) * Cin + ci;
#pragma unroll 8
        for (int c = 0; c < cend; ++c) {
          const float wv = wt[(size_t)c * Cin];
#pragma unroll
          for (int i = 0; i < FR_SEG; ++i) acc[i] = fmaf(dys[i + 2 - k][c], wv, acc[i]);
        }
      }
    }
    __syncthreads();
  }
  if (ci >= Cin) return;
  float* fr = frame + ((size_t)n * (2 * (W + 2) + 2 * H) + l.base) * Cin + ci;
#pragma unroll
  for (int i = 0; i < FR_SEG; ++i)
    if (j0 + i < l.len) fr[(size_t)(j0 + i) * Cin] = acc[i];
}

// ---------------------------------------------------------------------------
// Route 0: the interior, float32 on FMA. Here "x" is dy (Cin_k = Cout
// channels) and "y" is dx (Cout_k = Cin channels).

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
// Route 1: the pixels the fold reaches. The main pass stores their float32
// interior sums in a scratch buffer (N, 2W + 2H, Cin) instead of casting
// them, and dx_fold adds the frame and casts: so the main pass only stores,
// and no block waits on the frame. Slot of pixel (i, j), -1 for the others:
// row 1 at j, row H-2 at W + j, then column 1 at 2W + i and column W-2 at
// 2W + H + i for pixels of neither row.
__device__ __forceinline__ int fold_slot(int H, int W, int i, int j) {
  if (i == 1) return j;
  if (i == H - 2) return W + j;
  if (j == 1) return 2 * W + i;
  if (j == W - 2) return 2 * W + H + i;
  return -1;
}

// Block (slot, n): one fold pixel of one image, two channels a thread.
__global__ void __launch_bounds__(128)
dx_fold(const float* __restrict__ edge, const float* __restrict__ frame, bf16* __restrict__ dx,
        int H, int W, int Cin) {
  const int slot = blockIdx.x, n = blockIdx.y;
  int i, j;
  if (slot < 2 * W) {
    i = slot < W ? 1 : H - 2;
    j = slot % W;
  } else {
    i = (slot - 2 * W) % H;
    j = slot < 2 * W + H ? 1 : W - 2;
  }
  if (fold_slot(H, W, i, j) != slot) return;   // a pixel that another slot holds
  const float* e = edge + ((size_t)n * (2 * W + 2 * H) + slot) * Cin;
  const float* fr = frame + (size_t)n * (2 * (W + 2) + 2 * H) * Cin;
  bf16* out = dx + (((size_t)n * H + i) * W + j) * Cin;
  for (int c = 2 * threadIdx.x; c < Cin; c += 256) {   // Cin is a multiple of 8
    const float2 v = *reinterpret_cast<const float2*>(e + c);
    *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
        v.x + frame_fold(fr, H, W, Cin, i, j, c), v.y + frame_fold(fr, H, W, Cin, i, j, c + 1));
  }
}

// ---------------------------------------------------------------------------
// Route 1: the frame on mma.sync. A block owns one line of one image and
// GF_CI input channels; its eight warps own 16 positions each of a segment
// of up to GF_SEG positions (one segment unless the line is longer). Per
// round of GF_CO dy channels it stages the line's three kernel rows or
// columns (3 x GF_CI x GF_CO) and the segment's dy line (GF_SEG + 3
// entries), so each weight it reads serves the whole segment. Rows are
// padded to GF_P bf16 (36 words) so that the fragment loads of a warp hit
// 32 distinct banks.

constexpr int GF_THREADS = 256;
constexpr int GF_SEG = 128;
constexpr int GF_CI = 64;
constexpr int GF_CO = 64;
constexpr int GF_P = GF_CO + 8;
constexpr int GF_ROWS = GF_SEG + 3;
constexpr int GF_WV = 3 * GF_CI * (GF_CO / 8) / GF_THREADS;                    // 16-byte loads
constexpr int GF_DV = (GF_ROWS * (GF_CO / 8) + GF_THREADS - 1) / GF_THREADS;   // a thread stages
static_assert(3 * GF_CI * (GF_CO / 8) % GF_THREADS == 0, "whole weight loads per thread");

// One round's 16-byte loads of one thread: the line's three kernel rows or
// columns (w[ky][kx][ci0 + ci][co0 + co]) and the segment's dy line (entry r
// = index u0 - 2 + r), zero where they lie outside. All are issued before
// any is used, so a round costs one L2 round trip, and the next round's are
// in flight while this one's products run.
struct FrameRound {
  uint4 w[GF_WV];
  uint4 d[GF_DV];
};

__device__ __forceinline__ void frame_load(FrameRound& f, const bf16* __restrict__ dyn,
                                           const bf16* __restrict__ w, const FrameLine& l,
                                           int W, int Cin, int Cout, int ci0, int co0, int u0) {
#pragma unroll
  for (int q = 0; q < GF_WV; ++q) {
    const int i = threadIdx.x + q * GF_THREADS;
    const int cv = i % (GF_CO / 8), r = i / (GF_CO / 8);
    const int ci = r % GF_CI, k = r / GF_CI;
    const int ky = l.is_row ? l.fixed : k, kx = l.is_row ? k : l.fixed;
    const int co = co0 + cv * 8;
    f.w[q] = ci0 + ci < Cin && co < Cout
                 ? *reinterpret_cast<const uint4*>(w + ((size_t)(ky * 3 + kx) * Cin + ci0 + ci) * Cout + co)
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int q = 0; q < GF_DV; ++q) {
    const int i = threadIdx.x + q * GF_THREADS;
    const int cv = i % (GF_CO / 8), d = u0 - 2 + i / (GF_CO / 8);
    const int co = co0 + cv * 8;
    const int y = l.is_row ? l.dfix : d, x = l.is_row ? d : l.dfix;
    f.d[q] = i < GF_ROWS * (GF_CO / 8) && d >= 0 && d < l.dlen && co < Cout
                 ? *reinterpret_cast<const uint4*>(dyn + ((size_t)y * W + x) * Cout + co)
                 : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(GF_THREADS)
dx_frame_mma(const bf16* __restrict__ dy, const bf16* __restrict__ w,
             float* __restrict__ frame, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) bf16 ws[3][GF_CI][GF_P];
  __shared__ __align__(16) bf16 ds[GF_ROWS][GF_P];
  const FrameLine l = frame_line(blockIdx.x, H, W);
  const int n = blockIdx.y;
  const int ci0 = blockIdx.z * GF_CI;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const bf16* dyn = dy + (size_t)n * H * W * Cout;
  float* fr = frame + ((size_t)n * (2 * (W + 2) + 2 * H) + l.base) * Cin;

  for (int u0 = 0; u0 < l.len; u0 += GF_SEG) {
    const int m0 = warp * 16;                 // this warp's first position
    float acc[GF_CI / 8][4];
#pragma unroll
    for (int j = 0; j < GF_CI / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

    FrameRound f;
    frame_load(f, dyn, w, l, W, Cin, Cout, ci0, 0, u0);
    for (int co0 = 0; co0 < Cout; co0 += GF_CO) {
      __syncthreads();   // the last round's products have read ws and ds
#pragma unroll
      for (int q = 0; q < GF_WV; ++q) {
        const int i = tid + q * GF_THREADS;
        const int cv = i % (GF_CO / 8), r = i / (GF_CO / 8);
        *reinterpret_cast<uint4*>(&ws[r / GF_CI][r % GF_CI][cv * 8]) = f.w[q];
      }
#pragma unroll
      for (int q = 0; q < GF_DV; ++q) {
        const int i = tid + q * GF_THREADS;
        if (i < GF_ROWS * (GF_CO / 8))
          *reinterpret_cast<uint4*>(&ds[i / (GF_CO / 8)][(i % (GF_CO / 8)) * 8]) = f.d[q];
      }
      __syncthreads();
      if (co0 + GF_CO < Cout) frame_load(f, dyn, w, l, W, Cin, Cout, ci0, co0 + GF_CO, u0);
      if (u0 + m0 < l.len) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // position u0 + m0 + g takes staged row m0 + g + off + 2 - k
          const int r0 = m0 + l.off + 2 - k;
#pragma unroll
          for (int kk = 0; kk < GF_CO / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            uint32_t a[4];
            a[0] = lds32(&ds[r0 + g][c]);
            a[1] = lds32(&ds[r0 + g + 8][c]);
            a[2] = lds32(&ds[r0 + g][c + 8]);
            a[3] = lds32(&ds[r0 + g + 8][c + 8]);
#pragma unroll
            for (int j = 0; j < GF_CI / 8; ++j)
              mma_bf16(acc[j], a, lds32(&ws[k][j * 8 + g][c]), lds32(&ws[k][j * 8 + g][c + 8]));
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + m0 + g + 8 * h;
      if (u >= l.len) continue;
#pragma unroll
      for (int j = 0; j < GF_CI / 8; ++j) {
        const int ci = ci0 + j * 8 + 2 * t;
        if (ci < Cin)
          *reinterpret_cast<float2*>(fr + (size_t)u * Cin + ci) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
    __syncthreads();   // the next segment restages ws and ds
  }
}

// ---------------------------------------------------------------------------
// Route 1: the interior on wgmma. Shared memory: a ring of G_STAGES K-stages,
// each A (G_BM rows of 128 bytes) then B (G_BN rows of 128 bytes), both in
// the 128-byte swizzle that TMA writes and the wgmma descriptors name (the
// 16-byte chunk bits of an address XOR the bits just above 128 bytes); every
// tile starts on a 1024-byte boundary; then the full and empty barriers.

constexpr int G_TW = 64;                  // pixels of an image row a consumer owns
constexpr int G_BM = 2 * G_TW;            // pixels per block: two image rows
constexpr int G_BN = 256;                 // input channels per block
constexpr int G_BK = 64;                  // dy channels per K-stage: one 128-byte row
constexpr int G_STAGES = 4;
constexpr int G_THREADS = 384;            // producer + two consumers
constexpr int G_CONSUMERS = 256;
constexpr int G_A = G_BM * 128;
constexpr int G_STAGE = G_A + G_BN * 128;
constexpr int G_BAR = G_STAGES * G_STAGE;
constexpr int G_SMEM = G_BAR + 16 * G_STAGES + 1024;   // + slack to align the base

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of this parity has completed. (No trap on a long wait: one
// trap block shared by the producer and the consumers makes their paths
// meet, and ptxas then holds the consumers to the entry's 168 registers.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One box of a 3-D or 4-D tensor map (coordinates innermost first) to
// shared memory, its bytes counted on `bar`; what lies outside the tensor
// reads as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 256, float32) += a (64 x 16, shared) b^T (256 x 16, shared), both
// K-major.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// A block's tile: image n, rows y0 and y0 + 1, pixels x0 .. x0 + 63, input
// channels ci0 .. ci0 + 255. Tile t of N * ceil(H / 2) * ceil(W / 64) *
// ceil(Cin / 256), the input-channel block fastest.
struct Tile {
  int n, y0, x0, ci0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W, int Cin) {
  const int cblocks = (Cin + G_BN - 1) / G_BN, tiles_w = (W + G_TW - 1) / G_TW;
  const int tiles_h = (H + 1) / 2;
  Tile r;
  r.ci0 = (t % cblocks) * G_BN;
  t /= cblocks;
  r.x0 = (t % tiles_w) * G_TW;
  t /= tiles_w;
  r.y0 = (t % tiles_h) * 2;
  r.n = t / tiles_h;
  return r;
}

// One consumer warpgroup: image row y0 + cw of each of the block's tiles,
// over every K-stage. The ring's K-stages are counted across tiles (g):
// K-stage g is read from ring stage g % G_STAGES once its full barrier
// completes; its products stay in flight while the stage before is
// released on its empty barrier, so the producer fills the next tile's
// first stages while this one's epilogue stores. Accumulator layout
// (wgmma's): warp w of the group holds pixels 16w + g and 16w + g + 8 (g =
// lane / 4), register 4c + e input channel 8c + 2t + (e & 1) (t = lane % 4)
// of pixel g + 8 (e >> 1). The epilogue only stores: bf16 to dx, or the
// float32 sum to `edge` for a pixel the fold reaches (dx_fold finishes it).
// It loads nothing: the frame's loads here sat behind branches that a few
// lanes of every block take, and waited on L2 one by one.
__device__ __forceinline__ void dx_consume(uint32_t base, uint32_t full, uint32_t empty,
                                           int tiles, int ksteps, int cw,
                                           float* __restrict__ edge, bf16* __restrict__ dx,
                                           int H, int W, int Cin) {
  const int lane = threadIdx.x % 32;
  const int wl = (threadIdx.x / 32) % 4;
  const int g8 = lane >> 2;
  const int t = lane & 3;
  int g = 0;
  for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const Tile tl = tile_of(ti, H, W, Cin);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int j = 0; j < ksteps; ++j, ++g) {
      const int s = g % G_STAGES;
      mbar_wait(full + 8 * s, (g / G_STAGES) & 1);
      const uint32_t a = base + s * G_STAGE + cw * G_TW * 128;
      const uint32_t b = base + s * G_STAGE + G_A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk)
        wgmma_ss_n256(acc, make_desc(a + kk * 32, 16, 1024, 1),
                      make_desc(b + kk * 32, 16, 1024, 1));
      wgmma_commit();
      wgmma_wait_one();
      if (g > 0) mbar_arrive(empty + 8 * ((g - 1) % G_STAGES));
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);

    const int oy = tl.y0 + cw;
    if (oy >= H) continue;
    float* edge_n = edge + (size_t)tl.n * (2 * W + 2 * H) * Cin;
    bf16* dx_n = dx + (size_t)tl.n * H * W * Cin;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = tl.x0 + wl * 16 + g8 + 8 * h;
      if (ox >= W) continue;
      // epilogue stores begin (scripts/probe_torch_dx.py swaps what lies between the markers)
      const int slot = fold_slot(H, W, oy, ox);
      if (slot >= 0) {
        float* dst = edge_n + (size_t)slot * Cin + tl.ci0 + 2 * t;
#pragma unroll
        for (int c = 0; c < G_BN / 8; ++c)
          if (tl.ci0 + 8 * c + 2 * t < Cin)   // Cin is a multiple of 8, so ci + 1 < Cin too
            *reinterpret_cast<float2*>(dst + 8 * c) =
                make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      } else {
        bf16* dst = dx_n + ((size_t)oy * W + ox) * Cin + tl.ci0 + 2 * t;
#pragma unroll
        for (int c = 0; c < G_BN / 8; ++c)
          if (tl.ci0 + 8 * c + 2 * t < Cin)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
                __floats2bfloat162_rn(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
      // epilogue stores end
    }
  }
}

// dy comes in through a 4-D tensor map over (Cout, W, H, N) in boxes of (64,
// 64, 2, 1), w through a 3-D map over (Cout, Cin, 9) in boxes of (64, 256,
// 1). Persistent: block b takes tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(G_THREADS, 1)
dx_main_wgmma(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw,
              float* __restrict__ edge, bf16* __restrict__ dx, int tiles, int H, int W,
              int Cin, int Cout) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + G_BAR, empty = full + 8 * G_STAGES;
  const int chunks = (Cout + G_BK - 1) / G_BK;
  const int ksteps = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, G_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: K-stage g waits until the consumers have released g - G_STAGES
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
        const Tile tl = tile_of(ti, H, W, Cin);
        for (int j = 0; j < ksteps; ++j, ++g) {
          const int s = g % G_STAGES;
          const int tap = j / chunks, co0 = (j % chunks) * G_BK;
          const uint32_t a = base + s * G_STAGE;
          mbar_wait(empty + 8 * s, ((g / G_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, G_STAGE);
          // tap (ty, tx) of the flipped kernel reads dy at (y + ty - 1, x + tx - 1)
          tma_load_4d(a, &tdy, co0, tl.x0 + tap % 3 - 1, tl.y0 + tap / 3 - 1, tl.n, full + 8 * s);
          tma_load_3d(a + G_A, &tw, co0, tl.ci0, 8 - tap, full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    dx_consume(base, full, empty, tiles, ksteps, wg - 1, edge, dx, H, W, Cin);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library links no libcuda; null if the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 tensor of `rank` dims (innermost
// first) in boxes of `box`, in the 128-byte swizzle; what lies outside the
// tensor reads as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];   // bytes
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* dy, const void* w, float* frame, void* dx, int N, int H, int W,
                 int Cin, int Cout, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(frame)) %
                        16) == 0;
  if (Cin % 8 || Cout % 8 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tdy, tw;
  const cuuint64_t dy_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint32_t dy_box[4] = {G_BK, G_TW, 2, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint32_t w_box[3] = {G_BK, G_BN, 1};
  if (!tensor_map(&tdy, dy, 4, dy_dims, dy_box) || !tensor_map(&tw, w, 3, w_dims, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, once: the main pass's shared memory and one block per SM
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(dx_main_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bf16* dyb = static_cast<const bf16*>(dy);
  float* edge = frame + (size_t)N * (2 * (W + 2) + 2 * H) * Cin;
  dx_frame_mma<<<dim3(4, N, (Cin + GF_CI - 1) / GF_CI), GF_THREADS, 0, s>>>(
      dyb, static_cast<const bf16*>(w), frame, H, W, Cin, Cout);
  const long tiles = (long)N * ((H + 1) / 2) * ((W + G_TW - 1) / G_TW) * ((Cin + G_BN - 1) / G_BN);
  if (tiles > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  dx_main_wgmma<<<(unsigned)(tiles < sms[dev] ? tiles : sms[dev]), G_THREADS, G_SMEM, s>>>(
      tdy, tw, edge, static_cast<bf16*>(dx), (int)tiles, H, W, Cin, Cout);
  dx_fold<<<dim3(2 * W + 2 * H, N), 128, 0, s>>>(edge, frame, static_cast<bf16*>(dx), H, W, Cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dy (N,H,W,Cout); w: route 0 wf (3,3,Cout,Cin), the kernel flipped in both
// spatial axes with its channel axes swapped; route 1 the HWIO kernel
// (3,3,Cin,Cout) as it is; both in dy's dtype. frame: float32 scratch of
// N * (2(W+2) + 2H) * Cin, on route 1 N * (2(W+2) + 2H + 2W + 2H) * Cin. dx
// (N,H,W,Cin). route: 0 float32 (FMA), 1 bf16 (wgmma + TMA). Returns a
// cudaError_t after the launches (0 = cudaSuccess, cudaErrorInvalidValue for
// a shape or route the call does not take); all are asynchronous on
// `stream`.
extern "C" int reflect_conv3x3_dx(const void* dy, const void* w, void* frame, void* dx,
                                  int N, int H, int W, int Cin, int Cout, int route,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || H < 2 || W < 2 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* fr = static_cast<float*>(frame);
  if (route == 1) return launch_wgmma(dy, w, fr, dx, N, H, W, Cin, Cout, s);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int frame_segs = 2 * ((W + 2 + FR_SEG - 1) / FR_SEG) + 2 * ((H + FR_SEG - 1) / FR_SEG);
  const dim3 fgrid(frame_segs, N, (Cin + FR_THREADS - 1) / FR_THREADS);
  dx_frame<<<fgrid, FR_THREADS, 0, s>>>(static_cast<const float*>(dy),
                                        static_cast<const float*>(w), fr, H, W, Cin, Cout);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Cin + CO_T - 1) / CO_T, N);
  dx_main_f32<<<grid, THREADS, 0, s>>>(static_cast<const float*>(dy),
                                       static_cast<const float*>(w), fr,
                                       static_cast<float*>(dx), H, W, Cout, Cin, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
