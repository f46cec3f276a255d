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
