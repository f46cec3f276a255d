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
// What this design does about it. The (n, n) map never exists. bf16: a
// block owns 128 query rows of one image and all of d_v, so s is computed
// once per key tile. Three warpgroups: a producer, which setmaxnreg drops
// to 40 registers and whose one thread issues every load, and two
// consumers of 64 query rows each, raised to 232 registers. The producer
// fills a ring of four key tiles (64 keys of k and v each) by TMA over 3-D
// tensor maps of (B, n, d): rows past n and columns past d are zero-filled
// within their own image. Each stage has a full mbarrier (the TMA bytes)
// and an empty one (the consumers' release). s = q k^T is one
// wgmma.m64n64k16 per 16 columns of d_qk (q and k from shared memory, d_qk
// padded to 16, 32 or 64 with zero columns, rows in the swizzle of their
// width); o += bf16(p) v is wgmma.m64n256k16 with p packed from the s
// accumulator straight into the A registers and v read from shared memory
// as an MN-major operand in 64-column boxes with the 128-byte swizzle. The
// 64 x 256 float32 accumulator is 128 registers a thread. float32: FMA
// (never TF32) with s and p in shared memory.

#include <cuda.h>   // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;   // query rows per block (float32)
constexpr int BK = 64;   // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 on wgmma. Shared memory holds q (128 rows), a ring of key tiles of k
// and v, and the ring's mbarriers. q and k rows are 2 * DQK bytes (32, 64 or
// 128) in the swizzle of that width (TMA writes it, the wgmma descriptors
// name it: the 16-byte chunk bits of an address XOR the bits just above 128
// bytes); v is four boxes of 64 columns, each BKW rows of 128 bytes in the
// 128-byte swizzle. Every tile starts on a 1024-byte boundary.

constexpr int BQW = 128;      // query rows per block: two consumer warpgroups of 64
constexpr int BKW = 64;       // keys per tile
constexpr int DVW = 256;      // value columns per block: all of d_v
constexpr int STAGES = 4;
constexpr int NT = 384;       // threads per block: producer + two consumers
constexpr int CONSUMERS = 256;
constexpr int V_BOX = BKW * 128;          // one 64-column box of a v tile
constexpr int V_TILE = 4 * V_BOX;

template <int DQK>
struct Layout {
  static constexpr int RB = 2 * DQK;                      // bytes of a q or k row
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // wgmma swizzle code
  static constexpr int Q = 0;
  static constexpr int K = Q + BQW * RB;                  // [STAGES][BKW][RB]
  static constexpr int V = K + STAGES * BKW * RB;         // [STAGES][4][BKW][128]
  static constexpr int BAR = V + STAGES * V_TILE;         // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;   // + slack to align the base
};

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

// One box of a 3-D tensor map (coordinates innermost first) to shared
// memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 64, float32) = or += a (64 x 16, shared) b^T (64 x 16, shared),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, float32) += a (64 x 16, bf16 registers) b (16 x 256, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One consumer warpgroup: its 64 query rows against all keys, the online
// softmax and o. Key tile j is read from ring stage j % STAGES once its full
// barrier completes, and released on its empty barrier when both products
// have read it. Accumulator layout (wgmma's): warp w of the group holds rows
// 16w + g and 16w + g + 8 (g = lane / 4), register 4c + e column 8c + 2t +
// (e & 1) (t = lane % 4) of row g + 8 (e >> 1).
template <int DQK>
__device__ __forceinline__ void consume_rows(uint32_t base, uint32_t q_rows, uint32_t full,
                                             uint32_t empty, int n, bf16* __restrict__ o_img,
                                             float* __restrict__ lse_img, int row0, int dv) {
  using L = Layout<DQK>;
  const int lane = threadIdx.x % 32;
  const int wl = (threadIdx.x / 32) % 4;
  const int g = lane >> 2;
  const int t = lane & 3;

  float m_r[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l_r[2] = {0.f, 0.f};               // this thread's share of the running sum
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  const int nk = (n + BKW - 1) / BKW;
  for (int j = 0; j < nk; ++j) {
    const int stage = j % STAGES;
    mbar_wait(full + 8 * stage, (j / STAGES) & 1);
    const uint32_t k_tile = base + L::K + stage * BKW * L::RB;
    const uint32_t v_tile = base + L::V + stage * V_TILE;

    // s = q k^T: 64 rows x 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss_n64(s, make_desc(q_rows + kk * 32, 16, 8 * L::RB, L::MODE),
                   make_desc(k_tile + kk * 32, 16, 8 * L::RB, L::MODE), kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    // online softmax in log2 units; keys past n weigh nothing
    const int k0 = j * BKW;
    if (k0 + BKW > n) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h] * LOG2E);   // finite: every tile has a key
      alpha[h] = fast_exp2(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], LOG2E, -m_r[h]));
      l_r[h] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // acc += bf16(p) v: the s accumulator registers are the A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n256(acc, pa[kk], make_desc(v_tile + kk * 2048, V_BOX, 1024, 1));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    mbar_arrive(empty + 8 * stage);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wl * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* orow = o_img + (size_t)row * dv;
#pragma unroll
    for (int c = 0; c < DVW / 8; ++c) {
      if (c * 8 < dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[4 * c + 2 * h] * inv[h], acc[4 * c + 2 * h + 1] * inv[h]);
    }
    if (t == 0) lse_img[row] = (m_r[h] + log2f(l_r[h])) * LN2;
  }
}

// q, k and v come in through tensor maps over (B, n, d): boxes of (DQK,
// 128, 1) for q, (DQK, 64, 1) for k and (64, 64, 1) for v.
template <int DQK>
__global__ void __launch_bounds__(NT, 1)
attn_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              float* __restrict__ lse, int n, int dv) {
  using L = Layout<DQK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, q_full = empty + 8 * STAGES;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQW;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: stage j waits until the consumers have released tile j - STAGES
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, BQW * L::RB);
      tma_load(base + L::Q, &tq, 0, q0, b, q_full);
      const int boxes = (dv + 63) / 64;   // v boxes wholly past d_v are not loaded
      for (int j = 0; j < (n + BKW - 1) / BKW; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, BKW * L::RB + boxes * V_BOX);
        tma_load(base + L::K + s * BKW * L::RB, &tk, 0, j * BKW, b, full + 8 * s);
        for (int c = 0; c < boxes; ++c)
          tma_load(base + L::V + s * V_TILE + c * V_BOX, &tv, 64 * c, j * BKW, b, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    mbar_wait(q_full, 0);
    consume_rows<DQK>(base, base + L::Q + cw * 64 * L::RB, full, empty, n,
                      o + (size_t)b * n * dv, lse + (size_t)b * n, q0 + cw * 64, dv);
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

// A tensor map over a contiguous bf16 (B, n, d) tensor in boxes of (box_d,
// box_rows, 1); what lies past n or d reads as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int n, int d, int box_d,
                int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};   // bytes
  const cuuint32_t box[3] = {(cuuint32_t)box_d, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int n, int dqk, int dv, cudaStream_t st) {
  constexpr CUtensorMapSwizzle swz_qk = DQK == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : DQK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, n, dqk, DQK, BQW, swz_qk) ||
      !tensor_map(&tk, k, B, n, dqk, DQK, BKW, swz_qk) ||
      !tensor_map(&tv, v, B, n, dv, 64, BKW, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<DQK>::BYTES;
  auto kernel = attn_fwd_bf16<DQK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQW - 1) / BQW, B);
  kernel<<<grid, NT, smem, st>>>(tq, tk, tv, static_cast<bf16*>(o), lse, n, dv);
  return static_cast<int>(cudaGetLastError());
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
    if (dqk <= 16) return launch_bf16<16>(q, k, v, o, l, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_bf16<32>(q, k, v, o, l, B, n, dqk, dv, st);
    return launch_bf16<64>(q, k, v, o, l, B, n, dqk, dv, st);
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
