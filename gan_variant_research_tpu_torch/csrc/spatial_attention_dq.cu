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
//   contiguous; 8 <= d_qk <= 128 and 8 <= d_v <= 256 (d_v <= 128 when
//   d_qk > 64), both multiples of 8; lse, di (B, n) float32 (see
//   spatial_attention_dkv.cu).
//   p = exp(q k^T - lse), dp = do v^T, ds = p (dp - di) in float32; ds is
//   rounded to k's dtype before dQ = ds k, which sums in float32; dq is
//   cast once to the input dtype.
//
// What bounds it. 2 n^2 (2 d_qk + d_v) operations per image (p recomputed,
// dp, dQ): 129 GFLOP at B = 12, against ~60 MB of inputs and output:
// operation-bound on the tensor cores (0.130 ms at 989 TFLOP/s). dp is 80%
// of the operations.
//
// What this design does about it. Each block owns 128 queries of one image
// and walks every key in a fixed order, so dQ stays in registers until the
// end and each block writes its own rows: no atomics, the same bits from
// run to run. bf16 on wgmma, three warpgroups: a producer, which setmaxnreg
// drops to 24 registers and whose one thread starts every load, and two
// consumers of 64 queries each, raised to 240. The block's q and do are
// loaded once by TMA over 3-D tensor maps of (B, n, d), which zero-fill
// rows past n and columns past d within their own image; each consumer then
// holds its do rows as wgmma A fragments in registers (ldmatrix from the
// 128-byte swizzle; 64 registers at d_v 256), so that dp reads only v from
// shared memory. The producer fills a ring of 64-key tiles (k, and v in
// 64-column boxes), each stage with a full and an empty mbarrier. Per tile
// and consumer: s = q k^T (wgmma.m64n64k16, both operands K-major from
// shared memory) and dp = do v^T (m64n64k16, do from registers, v K-major);
// p = exp2(s log2e - lse log2e), keys past n masked to 0 by index (a
// zero-filled key has s = 0, and exp2(-lse log2e) overflows once lse <
// -88); ds = p (dp - di) packed to bf16 straight from the accumulators into
// the A registers; dQ += ds k (m64n{d_qk}k16, k as an MN-major operand: the
// stage that s read K-major). The two consumers take turns at the tensor
// cores (two named barriers): in its turn a consumer starts tile j's dQ
// product and tile j + 1's s and dp as one wgmma group, then waits for them,
// releases stage j and computes tile j + 1's ds while the other consumer's
// group runs. lse and di of a thread's two rows are read once (+inf and 0
// past n, so that such a row weighs nothing). At d_qk 128 dQ takes 64
// registers: that instance takes d_v up to 128, so do is 32 registers of A
// fragments (dQ 64 + do 32 + s, dp 32 each + ds 16), a wider v is cut into
// chunks of 128 columns by the caller, and q and k rows (256 bytes) come in
// as two 64-column boxes with the 128-byte swizzle. float32: FMA (never
// TF32), ds through shared memory, d_v <= 128 at d_qk > 64 as well.

#include <cuda.h>   // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 on wgmma. Shared memory holds the block's q (128 rows) and do (DVB
// 64-column boxes of 128 rows), a ring of key tiles (k, v in DVB 64-column
// boxes) and the mbarriers. q and k rows are 2 * DQK bytes (32, 64 or 128)
// in the swizzle of that width (TMA writes it, the wgmma descriptors name
// it), in two 64-column boxes at DQK 128; v and do rows are 128 bytes in the
// 128-byte swizzle. Every tile starts on a 1024-byte boundary.

constexpr int BQW = 128;      // queries per block: two consumer warpgroups of 64
constexpr int BKW = 64;       // keys per tile
constexpr int NT = 384;       // threads per block: producer + two consumers
constexpr int CONSUMERS = 256;
constexpr int DO_BOX = BQW * 128;   // one 64-column box of the block's do
constexpr int V_BOX = BKW * 128;    // one 64-column box of a v tile

template <int DQK>
struct Layout {
  static constexpr int STAGES = DQK == 64 ? 3 : 4;        // four do not fit at d_qk 64
  static constexpr int BOXC = DQK < 64 ? DQK : 64;        // columns of a q or k box
  static constexpr int NBOX = DQK / BOXC;                 // boxes of a q or k row
  static constexpr int RB = 2 * BOXC;                     // bytes of a q or k row in a box
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // wgmma swizzle code
  static constexpr int DVB = DQK == 128 ? 2 : 4;          // 64-column boxes of v and do
  static constexpr int Q_BOX = BQW * RB;
  static constexpr int K_BOX = BKW * RB;
  static constexpr int K_TILE = NBOX * K_BOX;
  static constexpr int V_TILE = DVB * V_BOX;
  static constexpr int Q = 0;                             // [NBOX][BQW][RB]
  static constexpr int DO = Q + NBOX * Q_BOX;             // [DVB][BQW][128]
  static constexpr int K = DO + DVB * DO_BOX;             // [STAGES][NBOX][BKW][RB]
  static constexpr int V = K + STAGES * K_TILE;           // [STAGES][DVB][BKW][128]
  static constexpr int BAR = V + STAGES * V_TILE;         // full[STAGES], empty[STAGES], q/do
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;   // + slack to align the base
  static_assert(BYTES <= 232448, "a block's shared memory");
  static_assert(Q_BOX % 1024 == 0 && K_BOX % 1024 == 0, "tiles on 1024-byte boundaries");
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
// meet, and ptxas then holds the consumers to the entry's registers.)
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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8; register i holds (row g, cols 2t, 2t+1) of
// matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// d (64 x 64, float32) = or += a (64 x 16, shared) b^T (64 x 16, shared),
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, float32) = or += a (64 x 16, bf16 registers) b^T (64 x 16,
// shared, K-major).
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, float32) += a (64 x 16, bf16 registers) b (16 x 128, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += a (64 x 16, bf16 registers) b (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, float32) += a (64 x 16, bf16 registers) b (16 x 32, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16, float32) += a (64 x 16, bf16 registers) b (16 x 16, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
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

// The two consumers take turns at starting their products (named barriers 1
// and 2, one a consumer, 256 threads: the waiting consumer's 128 and the
// other's 128 arrivals), so that one consumer's exponentials and ds run
// while the tensor cores work on the other's products.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// s = q k^T and dp = do v^T of one key tile (64 queries x BKW keys each),
// started as wgmmas: both operands of s from shared memory, K-major; do from
// the A registers and v K-major. Boxes of v wholly past d_v are not loaded.
template <int DQK>
__device__ __forceinline__ void mma_s_dp(float (&s)[BKW / 2], float (&dp)[BKW / 2],
                                           const uint32_t (&do_a)[4 * Layout<DQK>::DVB][4], uint32_t q_rows,
                                           uint32_t k_tile, uint32_t v_tile, int boxes) {
  using L = Layout<DQK>;
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const int box = kk / (L::BOXC / 16), col = (kk % (L::BOXC / 16)) * 32;
    wgmma_ss(s, make_desc(q_rows + box * L::Q_BOX + col, 16, 8 * L::RB, L::MODE), make_desc(k_tile + box * L::K_BOX + col, 16, 8 * L::RB, L::MODE), kk);
  }
#pragma unroll
  for (int c = 0; c < L::DVB; ++c) {
    if (c < boxes) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_kmajor(dp, do_a[4 * c + kk], make_desc(v_tile + c * V_BOX + kk * 32, 16, 1024, 1), c | kk);
    }
  }
}

// p and ds of one key tile from the s and dp accumulators (k0: its first
// key), ds packed to bf16 straight into the A fragments of dQ += ds k.
// Keys past n weigh nothing: their p is 0, whatever lse is. Accumulator
// layout (wgmma's): register 4c + e holds column 8c + 2t + (e & 1) of row
// g + 8 (e >> 1) of the warp's 16 (g = lane / 4, t = lane % 4); so
// registers 8kk..8kk+7 are the A fragment of keys 16kk..16kk+15.
__device__ __forceinline__ void ds_fragments(uint32_t (&da)[BKW / 16][4], float (&s)[BKW / 2],
                                             const float (&dp)[BKW / 2], const float (&l_r)[2],
                                             const float (&d_r)[2], int k0, int n, int t) {
  if (k0 + BKW > n) {
#pragma unroll
    for (int i = 0; i < BKW / 2; ++i)
      if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
  }
#pragma unroll
  for (int c = 0; c < BKW / 8; ++c) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * c + e], LOG2E, -l_r[e >> 1]));
      ds[e] = p * (dp[4 * c + e] - d_r[e >> 1]);
    }
    da[c / 2][2 * (c & 1)] = pack_bf16(ds[0], ds[1]);
    da[c / 2][2 * (c & 1) + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// One consumer warpgroup: its 64 queries against every key of the image.
// Key tile j is read from ring stage j % STAGES once its full barrier
// completes. In turn with the other consumer it starts dQ's product of tile
// j together with s and dp of tile j + 1, waits for both, releases stage j
// on its empty barrier, and computes tile j + 1's ds while the other
// consumer's products run.
template <int DQK>
__device__ __forceinline__ void consume_queries(uint32_t base, int cw, uint32_t full,
                                                uint32_t empty, uint32_t qdo_full, int n,
                                                int boxes, const float* __restrict__ lse_img,
                                                const float* __restrict__ di_img,
                                                bf16* __restrict__ dq_img, int row0, int dqk) {
  using L = Layout<DQK>;
  constexpr int STAGES = L::STAGES;
  const int lane = threadIdx.x % 32;
  const int wl = (threadIdx.x / 32) % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t q_rows = base + L::Q + cw * 64 * L::RB;

  // lse in log2 units and di of rows g and g + 8 of this warp's 16: +inf and
  // 0 past n, so that such a row's p and ds are 0
  float l_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wl * 16 + g + 8 * h;
    l_r[h] = row < n ? lse_img[row] * LOG2E : INFINITY;
    d_r[h] = row < n ? di_img[row] : 0.f;
  }
  float dq_acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dq_acc[i] = 0.f;

  // do as the A fragments of dp, once: 16 columns of d_v a fragment, four a
  // 64-column box; lane l reads row 16 wl + l % 8 + 8 ((l / 8) % 2), the 16
  // bytes of columns 8 (l / 16) on, where the 128-byte swizzle put them
  mbar_wait(qdo_full, 0);
  const int lrow = cw * 64 + wl * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const uint32_t do_row = base + L::DO + lrow * 128;
  uint32_t do_a[4 * L::DVB][4];
#pragma unroll
  for (int c = 0; c < L::DVB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      do_a[4 * c + kk][0] = do_a[4 * c + kk][1] = do_a[4 * c + kk][2] = do_a[4 * c + kk][3] = 0u;
      if (c < boxes) ldsm_x4(do_a[4 * c + kk], do_row + c * DO_BOX + (((2 * kk + lane / 16) ^ (lrow & 7)) << 4));
    }

  // tile 0's s and dp in this consumer's first turn (consumer 0 goes first)
  float s[BKW / 2], dp[BKW / 2];
  uint32_t da[BKW / 16][4];
#pragma unroll
  for (int i = 0; i < BKW / 2; ++i) s[i] = dp[i] = 0.f;
  if (cw == 1) turn_pass(cw);
  mbar_wait(full, 0);
  turn_wait(cw);
  wgmma_fence();
  mma_s_dp<DQK>(s, dp, do_a, q_rows, base + L::K, base + L::V, boxes);
  wgmma_commit();
  turn_pass(cw);
  wgmma_wait_all();
  reg_fence(s);
  reg_fence(dp);
  ds_fragments(da, s, dp, l_r, d_r, 0, n, t);

  const int nk = (n + BKW - 1) / BKW;
  for (int j = 0; j < nk; ++j) {
    const int stage = j % STAGES;
    const bool next = j + 1 < nk;
    const int stage1 = (j + 1) % STAGES;
    if (next) mbar_wait(full + 8 * stage1, ((j + 1) / STAGES) & 1);
    const uint32_t k_tile = base + L::K + stage * L::K_TILE;

    // dQ += bf16(ds) k (k as an MN-major operand), then tile j + 1's s, dp
    turn_wait(cw);
    reg_fence(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk)
      wgmma_rs(dq_acc, da[kk], make_desc(k_tile + kk * 16 * L::RB, L::K_BOX, 8 * L::RB, L::MODE));
    if (next)
      mma_s_dp<DQK>(s, dp, do_a, q_rows, base + L::K + stage1 * L::K_TILE,
                      base + L::V + stage1 * L::V_TILE, boxes);
    wgmma_commit();
    // every turn of consumer 0 is answered by one of consumer 1, whose last
    // turn passes nothing
    if (cw == 0 || next) turn_pass(cw);
    wgmma_wait_all();
    reg_fence(dq_acc);
    reg_fence(s);
    reg_fence(dp);
    mbar_arrive(empty + 8 * stage);
    if (next) ds_fragments(da, s, dp, l_r, d_r, (j + 1) * BKW, n, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wl * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* qrow = dq_img + (size_t)row * dqk;
#pragma unroll
    for (int c = 0; c < DQK / 8; ++c)
      if (c * 8 < dqk)
        *reinterpret_cast<__nv_bfloat162*>(qrow + c * 8 + 2 * t) =
            __floats2bfloat162_rn(dq_acc[4 * c + 2 * h], dq_acc[4 * c + 2 * h + 1]);
  }
}

// q, k, v and do come in through tensor maps over (B, n, d): boxes of (BOXC,
// 128, 1) for q, (BOXC, BKW, 1) for k, (64, BKW, 1) for v and (64, 128, 1)
// for do.
template <int DQK>
__global__ void __launch_bounds__(NT, 1)
attn_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dq, int n, int dqk, int dv) {
  using L = Layout<DQK>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, qdo_full = empty + 8 * STAGES;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQW;
  const int boxes = (dv + 63) / 64;   // v and do boxes wholly past d_v are not loaded
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(qdo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: stage j waits until the consumers have released tile j - STAGES
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, L::NBOX * L::Q_BOX + boxes * DO_BOX);
      for (int c = 0; c < L::NBOX; ++c)
        tma_load(base + L::Q + c * L::Q_BOX, &tq, c * L::BOXC, q0, b, qdo_full);
      for (int c = 0; c < boxes; ++c)
        tma_load(base + L::DO + c * DO_BOX, &tdo, 64 * c, q0, b, qdo_full);
      for (int j = 0; j < (n + BKW - 1) / BKW; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, L::K_TILE + boxes * V_BOX);
        for (int c = 0; c < L::NBOX; ++c)
          tma_load(base + L::K + s * L::K_TILE + c * L::K_BOX, &tk, c * L::BOXC, j * BKW, b,
                   full + 8 * s);
        for (int c = 0; c < boxes; ++c)
          tma_load(base + L::V + s * L::V_TILE + c * V_BOX, &tv, 64 * c, j * BKW, b, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    consume_queries<DQK>(base, cw, full, empty, qdo_full, n, boxes, lse + (size_t)b * n,
                         di + (size_t)b * n, dq + (size_t)b * n * dqk, q0 + cw * 64, dqk);
  }
}

// ---------------------------------------------------------------------------
// float32 on FMA: 256 threads, 64 query rows a block; ds of a (64 x 64)
// tile goes through shared memory; thread (ty, tx) accumulates dQ for rows
// ty + 16a and d_qk columns tx + 16c (c < KC: 4 up to d_qk 64, 8 up to 128).

constexpr int BQ_F32 = 64;
constexpr int BK = 64;   // keys per tile
constexpr int PS = BK + 1;

template <int KC>
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
  float acc[4][KC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[a][c] = 0.f;

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
      float da[4], kv[KC];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(ty + 16 * a) * PS + kk];
#pragma unroll
      for (int c = 0; c < KC; ++c) kv[c] = tx + 16 * c < dqk ? ks[kk * QS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[a][c] = fmaf(da[a], kv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (tx + 16 * c < dqk) dq[((size_t)b * n + row) * dqk + tx + 16 * c] = acc[a][c];
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
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* di, void* dq, int B, int n, int dqk, int dv,
                 cudaStream_t st) {
  using L = Layout<DQK>;
  constexpr CUtensorMapSwizzle swz_qk = L::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : L::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, n, dqk, L::BOXC, BQW, swz_qk) ||
      !tensor_map(&tk, k, B, n, dqk, L::BOXC, BKW, swz_qk) ||
      !tensor_map(&tv, v, B, n, dv, 64, BKW, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tdo, dout, B, n, dv, 64, BQW, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = L::BYTES;
  auto kernel = attn_dq_wgmma<DQK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQW - 1) / BQW, B);
  kernel<<<grid, NT, smem, st>>>(tq, tk, tv, tdo, lse, di, static_cast<bf16*>(dq), n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k (B, n, dqk), v, dout (B, n, dv) in one dtype (0 = float32,
// 1 = bfloat16); lse, di (B, n) float32; dq (B, n, dqk) in the input dtype;
// d_v <= 128 when d_qk > 64. Pointers 16-byte aligned. Returns a
// cudaError_t (0 = cudaSuccess, cudaErrorInvalidValue for shapes outside the
// contract); the launch is asynchronous on `stream`.
extern "C" int spatial_attention_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di, void* dq,
                                    int B, int n, int dqk, int dv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < 1 || dqk < 8 || dqk > 128 || dqk % 8 || dv < 8 ||
      dv > (dqk > 64 ? 128 : 256) || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    if (dqk <= 16) return launch_wgmma<16>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_wgmma<32>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
    if (dqk <= 64) return launch_wgmma<64>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
    return launch_wgmma<128>(q, k, v, dout, l, d, dq, B, n, dqk, dv, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * BQ_F32 * (dqk + 1) + 2 * BK * (dv + 1) + BQ_F32 * PS + 2 * BQ_F32) * 4;
  auto kernel = dqk <= 64 ? attn_dq_f32<4> : attn_dq_f32<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ_F32 - 1) / BQ_F32, 1, B);
  kernel<<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), l, d, static_cast<float*>(dq), n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}
