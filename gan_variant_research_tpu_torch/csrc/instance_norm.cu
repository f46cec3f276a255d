// Instance norm over the spatial dims of an NHWC bf16 tensor (no affine,
// biased variance), with the ReLU that may follow it, and its backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves gan_variant_research_tpu/
// ops/nn_ops.py::instance_norm to XLA, which fuses the formula. The port ran
// it as a chain of stock PyTorch ops (ops/nn_ops.py::instance_norm): a cast,
// two float32 means, a square, broadcast multiplies and subtracts, ~9
// kernels moving ~15 bytes an element forward and ~31 backward, with a
// float32 copy of x saved for autograd.
//
// Contract (ops/kernels/instance_norm.py's plain versions, which are
// today's chain's arithmetic):
//   x (N, HW, C) bf16 contiguous, any N, HW, C. Per (n, c), float32:
//     mean = (sum x) / HW, mean_sq = (sum x^2) / HW, var = mean_sq - mean^2
//     (kept unclamped in `stats`: the backward reads the clamp from its sign),
//     inv = rsqrt(max(var, 0) + eps), scale = bf16(inv), offset = bf16(mean * inv);
//     y = bf16(bf16(x * scale) - offset), then y <= 0 ? 0 : y with the ReLU.
//   stats (N, 2, C) float32: mean, var.
//   Backward, for the cotangent g (N, HW, C) bf16: g' = g, or 0 where y <= 0
//   with the ReLU (y recomputed from x and stats), then as autograd of the
//   chain: G1 = sum g', G2 = sum bf16(g' * x), each rounded to bf16 as the
//   chain's sum_to_size does; then
//     d_offset = -bf16(G1), d_scale = bf16(G2),
//     d_inv  = d_scale + d_offset * mean,
//     d_var  = var < 0 ? 0 : d_inv * -0.5 * inv^3        (rsqrt, then the clamp)
//     d_mean = d_offset * inv - 2 * mean * d_var          (offset, mean^2)
//     a = d_mean / HW, b = 2 * d_var / HW                  (both means)
//     dx = bf16(g' * scale + a + b * x), rounded once.
//
// What bounds it. Bytes: the forward reads x twice and writes y (6 bytes an
// element, 4 if the second read of x hits L2), the backward reads g and x
// twice and writes dx (10 bytes). At (12, 64, 64, 256), 12.6 M elements,
// that is 0.0225 ms forward and 0.0376 ms backward at 3.35 TB/s.
//
// What this design does about that. Each direction is three launches from
// one C call: a statistics pass over a grid of (pixel share s, channel block,
// n), each thread loading 16 bytes (8 channels) of a pixel per row, four rows
// in flight, and keeping float32 sums in registers, the block's rows summed
// in shared memory in a fixed order into a partial per (n, s, c); a finalize
// pass adding the S partials of each (n, c) in a fixed order (eight strided
// groups, then the groups in turn) and computing the per-channel
// coefficients; an apply pass over the same grid, each thread walking its
// rows from the last, so that it first reads what the statistics pass read
// last, still in L2. No atomics: the sums' order is fixed and two runs give
// the same bits. The streaming kernels are held to 64 registers, four
// 256-thread blocks an SM, and S is chosen by the caller from the shape and
// the SM count (instance_norm.py::norm_splits) so that the grid is one wave
// of them: small (N, C) still fill the card, and no second, partial wave
// runs at low occupancy. The roundings run on bf16 pairs (x * scale and g * x
// are exact in float32, so one bf16x2 multiply rounds them as the chain
// does); the ReLU's mask is the sign of x * scale - offset before its
// rounding, which rounding to bf16 keeps. Channel counts that are not
// multiples of 8 (or unaligned pointers) take the same kernels one channel a
// thread.
//
// The affine instance (the U-Net's norm, float32 gamma and beta, centred
// variance, one rounding) follows the non-affine one, with its own header
// and its own entry, affine_instance_norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;         // streaming kernels: blocks an SM (64 registers)
constexpr int TX_MAX = 32;            // channel vectors a block: one warp's width
constexpr int UNROLL = 4;             // rows a thread loads before it adds
constexpr int CPB = THREADS;          // channels a block at most: TX_MAX * 8
constexpr int GROUPS = 8;             // finalize: strided groups of the S partials

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC bf16 channels as loaded: 16 bytes (VEC 8) or one value (VEC 1).
template <int VEC> struct Raw;
template <> struct Raw<8> { uint4 v; };
template <> struct Raw<1> { bf16 v; };

template <int VEC>
__device__ __forceinline__ Raw<VEC> load_raw(const bf16* p) {
  Raw<VEC> r;
  if constexpr (VEC == 8) r.v = *reinterpret_cast<const uint4*>(p);
  else r.v = *p;
  return r;
}

template <int VEC>
__device__ __forceinline__ void unpack(const Raw<VEC>& r, float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    const bf162* h = reinterpret_cast<const bf162*>(&r.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = __bfloat162float(r.v);
  }
}

// f = bf16(a * b), as float: the product of two bf16 is exact in float32,
// so the bf16x2 multiply rounds it once, as float32-then-bf16 does.
template <int VEC>
__device__ __forceinline__ void mul_rn(const Raw<VEC>& a, const Raw<VEC>& b, float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    const bf162* ha = reinterpret_cast<const bf162*>(&a.v);
    const bf162* hb = reinterpret_cast<const bf162*>(&b.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(__hmul2(ha[i], hb[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = round_bf16(__bfloat162float(a.v) * __bfloat162float(b.v));
  }
}

template <int VEC>
__device__ __forceinline__ void store_rn(bf16* p, const float (&f)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(f[0]);
  }
}

template <int VEC>
__device__ __forceinline__ Raw<VEC> pack_rn(const float (&f)[VEC]) {
  Raw<VEC> r;
  store_rn<VEC>(reinterpret_cast<bf16*>(&r.v), f);
  return r;
}

// A block's layout: txn threads along C (VEC channels each), tyn rows of
// pixels; threads past txn * tyn idle. A thread's rows are p0 + ty + r * tyn
// for r < rows, in its block's share [p0, p1) of the pixels.
struct Geom {
  int txn, tyn, tx, ty, vi, rows, first;
  bool active;
  __device__ Geom(int HW, int C, int S, int s, int VEC, int cb) {
    const int cv = C / VEC;
    txn = cv < TX_MAX ? cv : TX_MAX;
    tyn = THREADS / txn;
    tx = threadIdx.x % txn;
    ty = threadIdx.x / txn;
    vi = cb * txn + tx;
    active = ty < tyn && vi < cv;
    const int chunk = (HW + S - 1) / S;
    const int p0 = s * chunk, p1 = min(HW, p0 + chunk);
    first = p0 + ty;
    rows = active && first < p1 ? (p1 - first + tyn - 1) / tyn : 0;
  }
  __device__ int pixel(int r) const { return first + r * tyn; }
};

// Sums the block's rows of s1 and s2 (tyn x txn*VEC each) in the order
// ty = 0..tyn-1 and writes them as the partial (n, s) of the block's channels.
template <int VEC>
__device__ void block_partial(const Geom& gm, const float (&s1)[VEC], const float (&s2)[VEC],
                             float* part, int n, int s, int S, int C, int cb) {
  __shared__ float red[2][THREADS * VEC];
  const int width = gm.txn * VEC;
  if (gm.ty < gm.tyn) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[0][gm.ty * width + gm.tx * VEC + k] = s1[k];
      red[1][gm.ty * width + gm.tx * VEC + k] = s2[k];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int c = cb * width + t;
  if (t < width && c < C) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < gm.tyn; ++r) {
      a += red[0][r * width + t];
      b += red[1][r * width + t];
    }
    float* dst = part + ((size_t)n * S + s) * 2 * C;
    dst[c] = a;
    dst[C + c] = b;
  }
}

// The finalize passes' block: 32 channels x GROUPS groups, grid (C / 32, N).
// Group j adds the partials s = j, j + GROUPS, ... in order; the groups' sums
// are added in the order j = 0..GROUPS-1. True for the thread that holds the
// channel's two sums (group 0), which then has c and n set.
__device__ bool sum_partials(const float* part, int S, int C, float& g1, float& g2, int& n,
                             int& c) {
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  n = blockIdx.y;
  c = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int s = j; s < S; s += GROUPS) {
      const float* src = part + ((size_t)n * S + s) * 2 * C;
      a += src[c];
      b += src[C + c];
    }
  }
  __shared__ float red[2][GROUPS][32];
  red[0][j][lane] = a;
  red[1][j][lane] = b;
  __syncthreads();
  if (j != 0 || c >= C) return false;
  g1 = g2 = 0.f;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    g1 += red[0][i][lane];
    g2 += red[1][i][lane];
  }
  return true;
}

// Loads the block's channels' K coefficients (n, k, c) of coef into shared memory.
template <int K>
__device__ void load_coef(const float* coef, float (&sh)[K][CPB], int n, int C, int width, int cb) {
  const int t = threadIdx.x;
  const int c = cb * width + t;
  if (t < width && c < C) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k][t] = coef[((size_t)n * K + k) * C + c];
  }
  __syncthreads();
}

// The thread's channels' scale (packed bf16) and offset from sh[0], sh[1].
template <int VEC, int K>
__device__ __forceinline__ void thread_coef(const Geom& gm, const float (&sh)[K][CPB],
                                            Raw<VEC>& scale, float (&scale_f)[VEC],
                                            float (&offset)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    scale_f[k] = gm.active ? sh[0][gm.tx * VEC + k] : 0.f;
    offset[k] = gm.active ? sh[1][gm.tx * VEC + k] : 0.f;
  }
  scale = pack_rn<VEC>(scale_f);   // bf16 values already: exact
}

// ---------------------------------------------------------------------------
// forward

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_fwd_stats(const bf16* __restrict__ x, float* __restrict__ part, int HW, int C, int S) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  const bf16* base = x + (size_t)n * HW * C + (size_t)gm.vi * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  int r = 0;
  for (; r + UNROLL <= gm.rows; r += UNROLL) {
    Raw<VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_raw<VEC>(base + (size_t)gm.pixel(r + u) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float f[VEC];
      unpack<VEC>(v[u], f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += f[k];
        s2[k] = fmaf(f[k], f[k], s2[k]);   // x^2 of a bf16 is exact in float32
      }
    }
  }
  for (; r < gm.rows; ++r) {
    float f[VEC];
    unpack<VEC>(load_raw<VEC>(base + (size_t)gm.pixel(r) * C), f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1[k] += f[k];
      s2[k] = fmaf(f[k], f[k], s2[k]);
    }
  }
  block_partial<VEC>(gm, s1, s2, part, n, s, S, C, cb);
}

// The statistics (N, 2, C), and the scale and offset (N, 2, C) as floats
// holding bf16 values.
__global__ void __launch_bounds__(THREADS)
inorm_fwd_finalize(const float* __restrict__ part, float* __restrict__ stats,
                   float* __restrict__ coef, int HW, int C, int S, float eps) {
  float a, b;
  int n, c;
  if (!sum_partials(part, S, C, a, b, n, c)) return;
  const float factor = 1.f / (float)HW;
  const float mean = a * factor, mean_sq = b * factor;
  const float var = mean_sq - mean * mean;
  const float inv = rsqrtf(fmaxf(var, 0.f) + eps);
  stats[(size_t)n * 2 * C + c] = mean;
  stats[((size_t)n * 2 + 1) * C + c] = var;
  coef[(size_t)n * 2 * C + c] = round_bf16(inv);
  coef[((size_t)n * 2 + 1) * C + c] = round_bf16(mean * inv);
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_fwd_apply(const bf16* __restrict__ x, const float* __restrict__ coef, bf16* __restrict__ y,
                int HW, int C, int S) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[2][CPB];
  load_coef<2>(coef, sh, n, C, gm.txn * VEC, cb);
  Raw<VEC> scale;
  float scale_f[VEC], offset[VEC];
  thread_coef<VEC, 2>(gm, sh, scale, scale_f, offset);
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  // rows from the last: the statistics pass read those last
  int r = gm.rows - 1;
  for (; r + 1 >= UNROLL; r -= UNROLL) {
    Raw<VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r - u) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float t[VEC];
      mul_rn<VEC>(v[u], scale, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float o = t[k] - offset[k];
        t[k] = RELU && o <= 0.f ? 0.f : o;
      }
      store_rn<VEC>(y + base + (size_t)gm.pixel(r - u) * C, t);
    }
  }
  for (; r >= 0; --r) {
    float t[VEC];
    mul_rn<VEC>(load_raw<VEC>(x + base + (size_t)gm.pixel(r) * C), scale, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float o = t[k] - offset[k];
      t[k] = RELU && o <= 0.f ? 0.f : o;
    }
    store_rn<VEC>(y + base + (size_t)gm.pixel(r) * C, t);
  }
}

// ---------------------------------------------------------------------------
// backward

// The scale and offset of the block's channels from the saved statistics,
// bit for bit the forward's.
__device__ void scale_offset(const float* stats, float (&sh)[2][CPB], int n, int C, int width,
                             int cb, float eps) {
  const int t = threadIdx.x;
  const int c = cb * width + t;
  if (t < width && c < C) {
    const float mean = stats[(size_t)n * 2 * C + c];
    const float var = stats[((size_t)n * 2 + 1) * C + c];
    const float inv = rsqrtf(fmaxf(var, 0.f) + eps);
    sh[0][t] = round_bf16(inv);
    sh[1][t] = round_bf16(mean * inv);
  }
  __syncthreads();
}

// G1 += g', G2 += bf16(g' * x) for one row; g' is g where x * scale -
// offset > 0 with the ReLU (the sign of the output before its rounding).
template <int VEC, bool RELU>
__device__ __forceinline__ void bwd_sums(const Raw<VEC>& g, const Raw<VEC>& x,
                                         const Raw<VEC>& scale, const float (&offset)[VEC],
                                         float (&s1)[VEC], float (&s2)[VEC]) {
  float gf[VEC], p[VEC];
  unpack<VEC>(g, gf);
  mul_rn<VEC>(g, x, p);
  if constexpr (RELU) {
    float t[VEC];
    mul_rn<VEC>(x, scale, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool keep = t[k] - offset[k] > 0.f;
      s1[k] += keep ? gf[k] : 0.f;
      s2[k] += keep ? p[k] : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1[k] += gf[k];
      s2[k] += p[k];
    }
  }
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_bwd_stats(const bf16* __restrict__ g, const bf16* __restrict__ x,
                const float* __restrict__ stats, float* __restrict__ part, int HW, int C, int S,
                float eps) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[2][CPB];
  Raw<VEC> scale;
  float scale_f[VEC], offset[VEC];
  if constexpr (RELU) {
    scale_offset(stats, sh, n, C, gm.txn * VEC, cb, eps);
    thread_coef<VEC, 2>(gm, sh, scale, scale_f, offset);
  }
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  int r = 0;
  for (; r + UNROLL <= gm.rows; r += UNROLL) {
    Raw<VEC> gv[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      gv[u] = load_raw<VEC>(g + base + (size_t)gm.pixel(r + u) * C);
      xv[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r + u) * C);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) bwd_sums<VEC, RELU>(gv[u], xv[u], scale, offset, s1, s2);
  }
  for (; r < gm.rows; ++r)
    bwd_sums<VEC, RELU>(load_raw<VEC>(g + base + (size_t)gm.pixel(r) * C),
                        load_raw<VEC>(x + base + (size_t)gm.pixel(r) * C), scale, offset, s1, s2);
  block_partial<VEC>(gm, s1, s2, part, n, s, S, C, cb);
}

// scale, offset, a, b (N, 4, C) of dx = g' * scale + a + b * x.
__global__ void __launch_bounds__(THREADS)
inorm_bwd_finalize(const float* __restrict__ part, const float* __restrict__ stats,
                   float* __restrict__ coef, int HW, int C, int S, float eps) {
  float g1, g2;
  int n, c;
  if (!sum_partials(part, S, C, g1, g2, n, c)) return;
  const float mean = stats[(size_t)n * 2 * C + c];
  const float var = stats[((size_t)n * 2 + 1) * C + c];
  const float inv = rsqrtf(fmaxf(var, 0.f) + eps);
  const float d_offset = -round_bf16(g1);
  const float d_scale = round_bf16(g2);
  const float d_inv = d_scale + d_offset * mean;
  const float d_var = var < 0.f ? 0.f : -0.5f * d_inv * (inv * inv * inv);
  const float d_mean = d_offset * inv - 2.f * mean * d_var;
  float* dst = coef + (size_t)n * 4 * C + c;
  dst[0] = round_bf16(inv);
  dst[C] = round_bf16(mean * inv);
  dst[2 * C] = d_mean / (float)HW;
  dst[3 * C] = 2.f * (d_var / (float)HW);
}

template <int VEC, bool RELU>
__device__ __forceinline__ void bwd_row(const Raw<VEC>& g, const Raw<VEC>& x,
                                        const Raw<VEC>& scale, const float (&scale_f)[VEC],
                                        const float (&offset)[VEC], const float (&a)[VEC],
                                        const float (&b)[VEC], bf16* out) {
  float gf[VEC], xf[VEC];
  unpack<VEC>(g, gf);
  unpack<VEC>(x, xf);
  if constexpr (RELU) {
    float t[VEC];
    mul_rn<VEC>(x, scale, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) gf[k] = t[k] - offset[k] > 0.f ? gf[k] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) gf[k] = gf[k] * scale_f[k] + fmaf(b[k], xf[k], a[k]);
  store_rn<VEC>(out, gf);
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_bwd_apply(const bf16* __restrict__ g, const bf16* __restrict__ x,
                const float* __restrict__ coef, bf16* __restrict__ dx, int HW, int C, int S) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[4][CPB];
  load_coef<4>(coef, sh, n, C, gm.txn * VEC, cb);
  Raw<VEC> scale;
  float scale_f[VEC], offset[VEC], a[VEC], b[VEC];
  thread_coef<VEC, 4>(gm, sh, scale, scale_f, offset);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = gm.active ? sh[2][gm.tx * VEC + k] : 0.f;
    b[k] = gm.active ? sh[3][gm.tx * VEC + k] : 0.f;
  }
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  int r = gm.rows - 1;
  for (; r + 1 >= UNROLL; r -= UNROLL) {
    Raw<VEC> gv[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      gv[u] = load_raw<VEC>(g + base + (size_t)gm.pixel(r - u) * C);
      xv[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r - u) * C);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      bwd_row<VEC, RELU>(gv[u], xv[u], scale, scale_f, offset, a, b,
                         dx + base + (size_t)gm.pixel(r - u) * C);
  }
  for (; r >= 0; --r)
    bwd_row<VEC, RELU>(load_raw<VEC>(g + base + (size_t)gm.pixel(r) * C),
                       load_raw<VEC>(x + base + (size_t)gm.pixel(r) * C), scale, scale_f, offset,
                       a, b, dx + base + (size_t)gm.pixel(r) * C);
}

// ---------------------------------------------------------------------------

template <int VEC, bool RELU>
void launch(const bf16* x, const bf16* g, float* part, float* coef, float* stats, bf16* out,
            int N, int HW, int C, int S, int backward, float eps, cudaStream_t st) {
  const int cv = C / VEC;
  const int txn = cv < TX_MAX ? cv : TX_MAX;
  const dim3 grid(S, (cv + txn - 1) / txn, N);
  const dim3 fin((C + 31) / 32, N);
  if (!backward) {
    inorm_fwd_stats<VEC><<<grid, THREADS, 0, st>>>(x, part, HW, C, S);
    inorm_fwd_finalize<<<fin, THREADS, 0, st>>>(part, stats, coef, HW, C, S, eps);
    inorm_fwd_apply<VEC, RELU><<<grid, THREADS, 0, st>>>(x, coef, out, HW, C, S);
  } else {
    inorm_bwd_stats<VEC, RELU><<<grid, THREADS, 0, st>>>(g, x, stats, part, HW, C, S, eps);
    inorm_bwd_finalize<<<fin, THREADS, 0, st>>>(part, stats, coef, HW, C, S, eps);
    inorm_bwd_apply<VEC, RELU><<<grid, THREADS, 0, st>>>(g, x, coef, out, HW, C, S);
  }
}

// ---------------------------------------------------------------------------
// The affine instance: models/generator_unet.py::AffineInstanceNorm (float32
// gamma and beta per channel), then the ReLU that may follow it. Its own
// kernels under the same names, in namespace affine, so the non-affine
// instances above keep their code; the two contracts differ in the variance
// (centred here) and in where they round (once here), so they share the
// loads, the block layout and the fixed-order sums, and no arithmetic.
//
// Contract (ops/kernels/instance_norm.py's affine_norm_*_reference):
//   Per (n, c), float32: mean and the centred biased variance var, from one
//     read of x: Welford's update over each thread's rows, then Chan's
//     pairwise merge over the block's rows and over the S shares, in a fixed
//     order. r = rsqrt(var + eps), gr = gamma * r.
//   y = bf16(gr * (x - mean) + beta) (one FMA, one rounding), then 0 where
//     that bf16 value is not > 0 with the ReLU.
//   stats (N, 2, C) float32: mean, var.
//   Backward, for the cotangent g: g' = g, or 0 where the forward's y is not
//   > 0 with the ReLU (recomputed from x and stats by the same arithmetic);
//     S1 = sum g', S2 = r * sum g' * (x - mean) (= sum g' * xhat), per (n, c);
//     dx = bf16(gr * ((g' - S1 / HW) - (x - mean) * r * S2 / HW)), rounded once;
//     dbeta = sum_n S1, dgamma = sum_n S2, float32, n in order.
//
// Bytes as the non-affine instance: x read twice forward, g and x twice
// backward, 6 and 10 bytes an element. Launches: statistics, finalize, apply
// forward; statistics, finalize (per (n, c)), finalize over n (gamma's and
// beta's gradient, one thread a channel: no atomics, so two runs give the
// same bits), apply backward. The backward kernels hold two rows in flight a
// thread, not four: their coefficients (mean, gr, beta, and the two sums'
// terms) take 40 of the 64 registers.

namespace affine {

constexpr int UNROLL_BWD = 2;

// Welford's update of one thread's (mean, m2) by one row; inv_k is 1 / k for
// the row's place k = 1, 2, ... in the thread's rows.
template <int VEC>
__device__ __forceinline__ void welford_row(const Raw<VEC>& v, float inv_k, float (&mean)[VEC],
                                            float (&m2)[VEC]) {
  float f[VEC];
  unpack<VEC>(v, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float d = f[k] - mean[k];
    mean[k] = fmaf(d, inv_k, mean[k]);
    m2[k] = fmaf(d, f[k] - mean[k], m2[k]);
  }
}

// (cnt, mean, m2) merged with (nb, mb, m2b): Chan et al.'s pairwise update.
__device__ __forceinline__ void chan(float& cnt, float& mean, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float t = cnt + nb;
  const float d = mb - mean;
  const float w = nb / t;
  mean = fmaf(d, w, mean);
  m2 = m2 + m2b + d * d * (cnt * w);
  cnt = t;
}

// How many pixels share s of S holds: [s * chunk, min(HW, (s + 1) * chunk)).
__device__ __forceinline__ float share_count(int HW, int S, int s) {
  const int chunk = (HW + S - 1) / S;
  return (float)max(0, min(HW, (s + 1) * chunk) - s * chunk);
}

// Merges the block's rows' (mean, m2) in the order ty = 0..tyn-1 and writes
// them as the partial (n, s) of the block's channels.
template <int VEC>
__device__ void block_moments(const Geom& gm, const float (&mean)[VEC], const float (&m2)[VEC],
                              float* part, int HW, int n, int s, int S, int C, int cb) {
  __shared__ float red[2][THREADS * VEC];
  const int width = gm.txn * VEC;
  if (gm.ty < gm.tyn) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[0][gm.ty * width + gm.tx * VEC + k] = mean[k];
      red[1][gm.ty * width + gm.tx * VEC + k] = m2[k];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int c = cb * width + t;
  if (t < width && c < C) {
    const int chunk = (HW + S - 1) / S;
    const int p1 = min(HW, (s + 1) * chunk);
    float cnt = 0.f, mu = 0.f, q = 0.f;
    for (int r = 0; r < gm.tyn; ++r) {
      const int first = s * chunk + r;
      const int rows = first < p1 ? (p1 - first + gm.tyn - 1) / gm.tyn : 0;
      chan(cnt, mu, q, (float)rows, red[0][r * width + t], red[1][r * width + t]);
    }
    float* dst = part + ((size_t)n * S + s) * 2 * C;
    dst[c] = mu;
    dst[C + c] = q;
  }
}

__device__ __forceinline__ float inv_std(float var, float eps) { return rsqrtf(var + eps); }

// The pre-activation gr * (x - mean) + beta, and whether the ReLU keeps it:
// its bf16 rounding, the value stored, is > 0.
__device__ __forceinline__ float pre(float x, float mean, float gr, float beta) {
  return fmaf(x - mean, gr, beta);
}
__device__ __forceinline__ bool kept(float v) {
  return __bfloat162float(__float2bfloat16_rn(v)) > 0.f;
}

// The block's channels' mean, gr and beta into sh[0..2] and, with K = 5, the
// backward's S1 / HW and r * S2 / HW into sh[3], sh[4], from the saved
// statistics: bit for bit the same in every pass.
template <int K>
__device__ void load_affine(const float* stats, const float* gamma, const float* beta,
                            const float* sums, float (&sh)[K][CPB], int n, int HW, int C,
                            int width, int cb, float eps) {
  const int t = threadIdx.x;
  const int c = cb * width + t;
  if (t < width && c < C) {
    const float mean = stats[(size_t)n * 2 * C + c];
    const float r = inv_std(stats[((size_t)n * 2 + 1) * C + c], eps);
    sh[0][t] = mean;
    sh[1][t] = gamma[c] * r;
    sh[2][t] = beta[c];
    if constexpr (K == 5) {
      sh[3][t] = sums[(size_t)n * 2 * C + c] / (float)HW;
      sh[4][t] = r * (sums[((size_t)n * 2 + 1) * C + c] / (float)HW);
    }
  }
  __syncthreads();
}

template <int VEC, int K>
__device__ __forceinline__ void thread_vals(const Geom& gm, const float (&sh)[K][CPB], int k,
                                            float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = gm.active ? sh[k][gm.tx * VEC + i] : 0.f;
}

// forward

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_fwd_stats(const bf16* __restrict__ x, float* __restrict__ part, int HW, int C, int S) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  const bf16* base = x + (size_t)n * HW * C + (size_t)gm.vi * VEC;
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
  int r = 0;
  for (; r + UNROLL <= gm.rows; r += UNROLL) {
    Raw<VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_raw<VEC>(base + (size_t)gm.pixel(r + u) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      welford_row<VEC>(v[u], __frcp_rn((float)(r + u + 1)), mean, m2);
  }
  for (; r < gm.rows; ++r)
    welford_row<VEC>(load_raw<VEC>(base + (size_t)gm.pixel(r) * C), __frcp_rn((float)(r + 1)),
                     mean, m2);
  block_moments<VEC>(gm, mean, m2, part, HW, n, s, S, C, cb);
}

// The statistics (N, 2, C): the S partials of each (n, c) merged in GROUPS
// strided groups (group j takes s = j, j + GROUPS, ... in order), the groups
// then merged in the order j = 0..GROUPS-1.
__global__ void __launch_bounds__(THREADS)
inorm_fwd_finalize(const float* __restrict__ part, float* __restrict__ stats, int HW, int C,
                   int S) {
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  const int n = blockIdx.y, c = blockIdx.x * 32 + lane;
  float cnt = 0.f, mu = 0.f, q = 0.f;
  if (c < C) {
    for (int s = j; s < S; s += GROUPS) {
      const float* src = part + ((size_t)n * S + s) * 2 * C;
      chan(cnt, mu, q, share_count(HW, S, s), src[c], src[C + c]);
    }
  }
  __shared__ float red[3][GROUPS][32];
  red[0][j][lane] = cnt;
  red[1][j][lane] = mu;
  red[2][j][lane] = q;
  __syncthreads();
  if (j != 0 || c >= C) return;
  cnt = mu = q = 0.f;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i)
    chan(cnt, mu, q, red[0][i][lane], red[1][i][lane], red[2][i][lane]);
  stats[(size_t)n * 2 * C + c] = mu;
  stats[((size_t)n * 2 + 1) * C + c] = q / (float)HW;
}

template <int VEC, bool RELU>
__device__ __forceinline__ void fwd_row(const Raw<VEC>& v, const float (&mean)[VEC],
                                        const float (&gr)[VEC], const float (&bt)[VEC], bf16* out) {
  float f[VEC];
  unpack<VEC>(v, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float p = pre(f[k], mean[k], gr[k], bt[k]);
    f[k] = RELU && !kept(p) ? 0.f : p;
  }
  store_rn<VEC>(out, f);
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_fwd_apply(const bf16* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                bf16* __restrict__ y, int HW, int C, int S, float eps) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[3][CPB];
  load_affine<3>(stats, gamma, beta, nullptr, sh, n, HW, C, gm.txn * VEC, cb, eps);
  float mean[VEC], gr[VEC], bt[VEC];
  thread_vals<VEC, 3>(gm, sh, 0, mean);
  thread_vals<VEC, 3>(gm, sh, 1, gr);
  thread_vals<VEC, 3>(gm, sh, 2, bt);
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  // rows from the last: the statistics pass read those last
  int r = gm.rows - 1;
  for (; r + 1 >= UNROLL; r -= UNROLL) {
    Raw<VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r - u) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      fwd_row<VEC, RELU>(v[u], mean, gr, bt, y + base + (size_t)gm.pixel(r - u) * C);
  }
  for (; r >= 0; --r)
    fwd_row<VEC, RELU>(load_raw<VEC>(x + base + (size_t)gm.pixel(r) * C), mean, gr, bt,
                       y + base + (size_t)gm.pixel(r) * C);
}

// backward

// g' of one row, and x - mean, as floats.
template <int VEC, bool RELU>
__device__ __forceinline__ void masked(const Raw<VEC>& g, const Raw<VEC>& x,
                                       const float (&mean)[VEC], const float (&gr)[VEC],
                                       const float (&bt)[VEC], float (&gk)[VEC],
                                       float (&d)[VEC]) {
  float xf[VEC];
  unpack<VEC>(g, gk);
  unpack<VEC>(x, xf);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    d[k] = xf[k] - mean[k];
    if constexpr (RELU) gk[k] = kept(pre(xf[k], mean[k], gr[k], bt[k])) ? gk[k] : 0.f;
  }
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_bwd_stats(const bf16* __restrict__ g, const bf16* __restrict__ x,
                const float* __restrict__ stats, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ part, int HW, int C, int S,
                float eps) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[3][CPB];
  load_affine<3>(stats, gamma, beta, nullptr, sh, n, HW, C, gm.txn * VEC, cb, eps);
  float mean[VEC], gr[VEC], bt[VEC];
  thread_vals<VEC, 3>(gm, sh, 0, mean);
  thread_vals<VEC, 3>(gm, sh, 1, gr);
  thread_vals<VEC, 3>(gm, sh, 2, bt);
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  int r = 0;
  for (; r < gm.rows; r += UNROLL_BWD) {
    const int m = min(UNROLL_BWD, gm.rows - r);
    Raw<VEC> gv[UNROLL_BWD], xv[UNROLL_BWD];
#pragma unroll
    for (int u = 0; u < UNROLL_BWD; ++u) {
      if (u < m) {
        gv[u] = load_raw<VEC>(g + base + (size_t)gm.pixel(r + u) * C);
        xv[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r + u) * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL_BWD; ++u) {
      if (u < m) {
        float gk[VEC], d[VEC];
        masked<VEC, RELU>(gv[u], xv[u], mean, gr, bt, gk, d);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s1[k] += gk[k];
          s2[k] = fmaf(gk[k], d[k], s2[k]);
        }
      }
    }
  }
  block_partial<VEC>(gm, s1, s2, part, n, s, S, C, cb);
}

// Per (n, c): S1 and S2 (N, 2, C) into sums, the partials added as the
// non-affine finalize adds them.
__global__ void __launch_bounds__(THREADS)
inorm_bwd_finalize(const float* __restrict__ part, const float* __restrict__ stats,
                   float* __restrict__ sums, int C, int S, float eps) {
  float g1, g2;
  int n, c;
  if (!sum_partials(part, S, C, g1, g2, n, c)) return;
  const float r = inv_std(stats[((size_t)n * 2 + 1) * C + c], eps);
  sums[(size_t)n * 2 * C + c] = g1;
  sums[((size_t)n * 2 + 1) * C + c] = r * g2;
}

// The finalize over n: dgamma (C) then dbeta (C) into dparams, each the sum
// of sums' (n, c) over n = 0..N-1 in order; one thread a channel.
__global__ void __launch_bounds__(THREADS)
inorm_bwd_finalize(const float* __restrict__ sums, float* __restrict__ dparams, int N, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    s1 += sums[(size_t)n * 2 * C + c];
    s2 += sums[((size_t)n * 2 + 1) * C + c];
  }
  dparams[c] = s2;
  dparams[C + c] = s1;
}

template <int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inorm_bwd_apply(const bf16* __restrict__ g, const bf16* __restrict__ x,
                const float* __restrict__ stats, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ sums,
                bf16* __restrict__ dx, int HW, int C, int S, float eps) {
  const int s = blockIdx.x, cb = blockIdx.y, n = blockIdx.z;
  const Geom gm(HW, C, S, s, VEC, cb);
  __shared__ float sh[5][CPB];
  load_affine<5>(stats, gamma, beta, sums, sh, n, HW, C, gm.txn * VEC, cb, eps);
  float mean[VEC], gr[VEC], bt[VEC], a[VEC], rb[VEC];
  thread_vals<VEC, 5>(gm, sh, 0, mean);
  thread_vals<VEC, 5>(gm, sh, 1, gr);
  thread_vals<VEC, 5>(gm, sh, 2, bt);
  thread_vals<VEC, 5>(gm, sh, 3, a);
  thread_vals<VEC, 5>(gm, sh, 4, rb);
  const size_t base = (size_t)n * HW * C + (size_t)gm.vi * VEC;
  // rows from the last: the statistics pass read those last
  for (int r = gm.rows - 1; r >= 0; r -= UNROLL_BWD) {
    const int m = min(UNROLL_BWD, r + 1);
    Raw<VEC> gv[UNROLL_BWD], xv[UNROLL_BWD];
#pragma unroll
    for (int u = 0; u < UNROLL_BWD; ++u) {
      if (u < m) {
        gv[u] = load_raw<VEC>(g + base + (size_t)gm.pixel(r - u) * C);
        xv[u] = load_raw<VEC>(x + base + (size_t)gm.pixel(r - u) * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL_BWD; ++u) {
      if (u < m) {
        float gk[VEC], d[VEC];
        masked<VEC, RELU>(gv[u], xv[u], mean, gr, bt, gk, d);
#pragma unroll
        for (int k = 0; k < VEC; ++k) gk[k] = gr[k] * fmaf(-d[k], rb[k], gk[k] - a[k]);
        store_rn<VEC>(dx + base + (size_t)gm.pixel(r - u) * C, gk);
      }
    }
  }
}

template <int VEC, bool RELU>
void launch(const bf16* x, const bf16* g, const float* gamma, const float* beta, float* part,
            float* sums, float* stats, bf16* out, float* dparams, int N, int HW, int C, int S,
            int backward, float eps, cudaStream_t st) {
  const int cv = C / VEC;
  const int txn = cv < TX_MAX ? cv : TX_MAX;
  const dim3 grid(S, (cv + txn - 1) / txn, N);
  const dim3 fin((C + 31) / 32, N);
  if (!backward) {
    inorm_fwd_stats<VEC><<<grid, THREADS, 0, st>>>(x, part, HW, C, S);
    inorm_fwd_finalize<<<fin, THREADS, 0, st>>>(part, stats, HW, C, S);
    inorm_fwd_apply<VEC, RELU><<<grid, THREADS, 0, st>>>(x, stats, gamma, beta, out, HW, C, S,
                                                         eps);
  } else {
    inorm_bwd_stats<VEC, RELU><<<grid, THREADS, 0, st>>>(g, x, stats, gamma, beta, part, HW, C,
                                                         S, eps);
    inorm_bwd_finalize<<<fin, THREADS, 0, st>>>(part, stats, sums, C, S, eps);
    inorm_bwd_finalize<<<(C + THREADS - 1) / THREADS, THREADS, 0, st>>>(sums, dparams, N, C);
    inorm_bwd_apply<VEC, RELU><<<grid, THREADS, 0, st>>>(g, x, stats, gamma, beta, sums, out,
                                                         HW, C, S, eps);
  }
}

}  // namespace affine

}  // namespace

// x, g (backward only; null forward), out (y or dx): (N, HW, C) bf16
// contiguous. work: N*S*2*C + N*4*C floats of scratch (the partials, then the
// coefficients). stats: (N, 2, C) float32, written forward, read backward.
// eps_bits: the float eps's bits. Returns the launch's CUDA error, 0 if none.
extern "C" int instance_norm(const void* x, const void* g, void* work, void* stats, void* out,
                             int N, int HW, int C, int S, int relu, int backward, int eps_bits,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || HW < 1 || C < 1 || S < 1 || S > HW || (backward && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float eps;
  memcpy(&eps, &eps_bits, sizeof(eps));
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  float* part = static_cast<float*>(work);
  float* coef = part + (size_t)N * S * 2 * C;
  float* sf = static_cast<float*>(stats);
  bf16* ob = static_cast<bf16*>(out);
  const bool aligned = ((uintptr_t)x | (uintptr_t)g | (uintptr_t)out) % 16 == 0;
  if (C % 8 == 0 && aligned) {
    if (relu) launch<8, true>(xb, gb, part, coef, sf, ob, N, HW, C, S, backward, eps, st);
    else launch<8, false>(xb, gb, part, coef, sf, ob, N, HW, C, S, backward, eps, st);
  } else {
    if (relu) launch<1, true>(xb, gb, part, coef, sf, ob, N, HW, C, S, backward, eps, st);
    else launch<1, false>(xb, gb, part, coef, sf, ob, N, HW, C, S, backward, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The affine instance. x, g (backward only; null forward), out (y or dx):
// (N, HW, C) bf16 contiguous. gamma, beta: (C) float32. work: as
// instance_norm's (the partials, then the backward's per-(n, c) sums S1, S2
// in the coefficients' room). stats: (N, 2, C) float32 mean and centred
// variance, written forward, read backward. dparams (backward only; null
// forward): (2, C) float32, dgamma then dbeta. eps_bits: the float eps's
// bits. Returns the launch's CUDA error, 0 if none.
extern "C" int affine_instance_norm(const void* x, const void* g, const void* gamma,
                                    const void* beta, void* work, void* stats, void* out,
                                    void* dparams, int N, int HW, int C, int S, int relu,
                                    int backward, int eps_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || HW < 1 || C < 1 || S < 1 || S > HW || gamma == nullptr ||
      beta == nullptr || (backward && (g == nullptr || dparams == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float eps;
  memcpy(&eps, &eps_bits, sizeof(eps));
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* gf = static_cast<const float*>(gamma);
  const float* bf = static_cast<const float*>(beta);
  float* part = static_cast<float*>(work);
  float* sums = part + (size_t)N * S * 2 * C;
  float* sf = static_cast<float*>(stats);
  bf16* ob = static_cast<bf16*>(out);
  float* dp = static_cast<float*>(dparams);
  const bool aligned = ((uintptr_t)x | (uintptr_t)g | (uintptr_t)out) % 16 == 0;
  void (*run)(const bf16*, const bf16*, const float*, const float*, float*, float*, float*,
              bf16*, float*, int, int, int, int, int, float, cudaStream_t);
  if (C % 8 == 0 && aligned) {
    if (relu) run = affine::launch<8, true>;
    else run = affine::launch<8, false>;
  } else {
    if (relu) run = affine::launch<1, true>;
    else run = affine::launch<1, false>;
  }
  run(xb, gb, gf, bf, part, sums, sf, ob, dp, N, HW, C, S, backward, eps, st);
  return static_cast<int>(cudaGetLastError());
}
