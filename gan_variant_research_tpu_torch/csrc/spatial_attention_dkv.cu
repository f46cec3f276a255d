// Spatial self-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces _flash_attention_bwd_dkv of the Pallas TPU flash-attention
// kernel (jax/experimental/pallas/ops/tpu/flash_attention.py:941, body
// _flash_attention_dkv_kernel) behind gan_variant_research_tpu/models/
// attention.py::flash_spatial_attention: the key and value gradients of the
// variant generator's SAGAN core, n = 4096, d_qk = 32, d_v = 256.
//
// Contract (the library kernel's, sm_scale = 1, non-causal):
//   q, k (B, n, d_qk), v, do (B, n, d_v), one dtype, float32 or bfloat16,
//   contiguous; 8 <= d_qk <= 128 and 8 <= d_v <= 256 (d_v <= 128 when
//   d_qk > 64), both multiples of 8; lse (B, n) float32 from the forward (it
//   depends on q and k alone, so one forward's lse serves any column chunk
//   of v); di (B, n) float32 =
//   sum(o * do) over d_v (computed outside, as the library does).
//   p = exp(q k^T - lse) in float32;
//   dV = p^T do, with p rounded to do's dtype before the product;
//   dp = do v^T in float32, ds = p (dp - di), rounded to do's dtype;
//   dK = ds^T q. Sums in float32, dk and dv cast once to the input dtype.
//   One head of width d_v: the library's 128-wide heads share p, so their
//   dk sum over heads is this dk, up to the rounding of ds (once here, once
//   per head there).
//
// What bounds it. 2 n^2 (2 d_qk + 2 d_v) operations per image (p recomputed,
// dV, dp, dK): 232 GFLOP at B = 12, against ~85 MB of inputs and outputs:
// operation-bound on the tensor cores (0.234 ms at 989 TFLOP/s).
//
// What this design does about it. Each block owns 128 keys of one image
// and walks all of its queries, so dK and dV stay in registers until the
// end and each block writes its own rows: no atomics, the same bits from
// run to run. bf16 on wgmma, three warpgroups: a producer, which setmaxnreg
// drops to 24 registers, and two consumers of 64 keys each, raised to 240.
// The block's k and v are loaded once by TMA; the producer's warp fills a
// ring of four query tiles (q and do by TMA over 3-D tensor maps of (B, n,
// d), which zero-fill rows past n and columns past d; lse and di by its
// lanes, +inf and 0 past n so that such a query weighs nothing). Each
// consumer works key-major, so that p^T and ds^T leave the accumulators as
// the A registers of the next product, with no exchange through shared
// memory: s^T = k q^T and dp^T = v do^T (wgmma.m64n64k16, both operands
// K-major from shared memory; v and do in 64-column boxes with the 128-byte
// swizzle), p^T = exp2(s^T log2e - lse log2e), ds^T = p^T (dp^T - di);
// then dV += bf16(p^T) do (m64n256k16, do as an MN-major operand, the
// forward's v layout) and dK += bf16(ds^T) q (m64n{d_qk}k16, q MN-major).
// Registers a consumer thread: dV 128, dK d_qk / 2, s^T and dp^T 32 each.
// At d_qk 64 the query tile is 32 (s^T and dp^T 16 each) so that the 240
// registers hold. At d_qk 128 dK alone takes 64: that instance takes d_v up
// to 128 (dV 64 registers, m64n128k16), so a consumer holds dV 64 + dK 64 +
// s^T, dp^T 16 each + the A fragments 16, and the caller cuts a wider v into
// chunks of 128 columns, each with its own di; q and k rows (256 bytes) come
// in as two 64-column boxes with the 128-byte swizzle. float32: FMA (never
// TF32), p and ds through shared memory, d_v <= 128 at d_qk > 64 as well.

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
// bf16 on wgmma. Shared memory holds the block's k (128 rows) and v (DVB
// 64-column boxes of 128 rows), a ring of query tiles (q, do in DVB
// 64-column boxes, lse and di), and the ring's mbarriers. q and k rows are
// 2 * DQK bytes (32, 64 or 128) in the swizzle of that width (TMA writes
// it, the wgmma descriptors name it), in two 64-column boxes at DQK 128; v
// and do rows are 128 bytes in the 128-byte swizzle. Every tile starts on a
// 1024-byte boundary.

constexpr int BKB = 128;      // keys per block: two consumer warpgroups of 64
constexpr int STAGES = 4;
constexpr int NT = 384;       // threads per block: producer + two consumers
constexpr int CONSUMERS = 256;
constexpr int V_BOX = BKB * 128;   // one 64-column box of the block's v

template <int DQK>
struct Layout {
  static constexpr int BQ = DQK >= 64 ? 32 : 64;          // queries per tile
  static constexpr int BOXC = DQK < 64 ? DQK : 64;        // columns of a q or k box
  static constexpr int NBOX = DQK / BOXC;                 // boxes of a q or k row
  static constexpr int RB = 2 * BOXC;                     // bytes of a q or k row in a box
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // wgmma swizzle code
  static constexpr int DVB = DQK == 128 ? 2 : 4;          // 64-column boxes of v and do
  static constexpr int DO_BOX = BQ * 128;                 // one 64-column box of a do tile
  static constexpr int Q_BOX = BQ * RB;
  static constexpr int Q_TILE = NBOX * Q_BOX;
  static constexpr int K_BOX = BKB * RB;
  static constexpr int K = 0;                             // [NBOX][BKB][RB]
  static constexpr int V = K + NBOX * K_BOX;              // [DVB][BKB][128]
  static constexpr int Q = V + DVB * V_BOX;               // [STAGES][NBOX][BQ][RB]
  static constexpr int DO = Q + STAGES * Q_TILE;          // [STAGES][DVB][BQ][128]
  static constexpr int LSE = DO + STAGES * DVB * DO_BOX;  // [STAGES][BQ] float, log2 units
  static constexpr int DI = LSE + STAGES * BQ * 4;        // [STAGES][BQ] float
  static constexpr int BAR = DI + STAGES * BQ * 4;        // full[STAGES], empty[STAGES], kv
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;   // + slack to align the base
  static_assert(Q_BOX % 1024 == 0 && K_BOX % 1024 == 0, "tiles on 1024-byte boundaries");
  static_assert(BYTES <= 232448, "a block's shared memory");
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

// d (64 x 32, float32) = or += a (64 x 16, shared) b^T (32 x 16, shared),
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, float32) += a (64 x 16, bf16 registers) b (16 x 256, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// One consumer warpgroup: its 64 keys against every query of the image.
// Query tile j is read from ring stage j % STAGES once its full barrier
// completes, and released on its empty barrier when all four products have
// read it. Accumulator layout (wgmma's): warp w of the group holds rows
// 16w + g and 16w + g + 8 (g = lane / 4), register 4c + e column 8c + 2t +
// (e & 1) (t = lane % 4) of row g + 8 (e >> 1); rows are keys, so the
// registers 8kk..8kk+7 of s^T or ds^T are the A fragment of queries
// 16kk..16kk+15.
template <int DQK>
__device__ __forceinline__ void consume_keys(uint32_t base, const float* __restrict__ lse_s,
                                             const float* __restrict__ di_s, int cw,
                                             uint32_t full, uint32_t empty, uint32_t kv_full,
                                             int n, int boxes, bf16* __restrict__ dk_img,
                                             bf16* __restrict__ dv_img, int key0, int dqk,
                                             int dv) {
  using L = Layout<DQK>;
  constexpr int BQ = L::BQ;
  const int lane = threadIdx.x % 32;
  const int wl = (threadIdx.x / 32) % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t k_rows = base + L::K + cw * 64 * L::RB;
  const uint32_t v_rows = base + L::V + cw * 64 * 128;

  float dv_acc[32 * L::DVB];
  float dk_acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < 32 * L::DVB; ++i) dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dk_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  const int nq = (n + BQ - 1) / BQ;
  for (int j = 0; j < nq; ++j) {
    const int stage = j % STAGES;
    mbar_wait(full + 8 * stage, (j / STAGES) & 1);
    const uint32_t q_tile = base + L::Q + stage * L::Q_TILE;
    const uint32_t do_tile = base + L::DO + stage * L::DVB * L::DO_BOX;

    // s^T = k q^T and dp^T = v do^T: 64 keys x BQ queries each
    float st[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const int box = kk / (L::BOXC / 16), col = (kk % (L::BOXC / 16)) * 32;
      wgmma_ss(st, make_desc(k_rows + box * L::K_BOX + col, 16, 8 * L::RB, L::MODE),
               make_desc(q_tile + box * L::Q_BOX + col, 16, 8 * L::RB, L::MODE), kk);
    }
    for (int c = 0; c < boxes; ++c) {   // boxes wholly past d_v are not loaded
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, make_desc(v_rows + c * V_BOX + kk * 32, 16, 1024, 1),
                 make_desc(do_tile + c * L::DO_BOX + kk * 32, 16, 1024, 1), c | kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dp);

    // p^T and ds^T, packed to bf16 straight into the A fragments
    const float* lse_t = lse_s + stage * BQ;
    const float* di_t = di_s + stage * BQ;
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * c + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(di_t + 8 * c + 2 * t);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(fmaf(st[4 * c + e], LOG2E, -(e & 1 ? l.y : l.x)));
        ds[e] = p[e] * (dp[4 * c + e] - (e & 1 ? d.y : d.x));
      }
      pa[c / 2][2 * (c & 1)] = pack_bf16(p[0], p[1]);
      pa[c / 2][2 * (c & 1) + 1] = pack_bf16(p[2], p[3]);
      da[c / 2][2 * (c & 1)] = pack_bf16(ds[0], ds[1]);
      da[c / 2][2 * (c & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += bf16(p^T) do, dK += bf16(ds^T) q
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dv_acc, pa[kk], make_desc(do_tile + kk * 2048, L::DO_BOX, 1024, 1));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dk_acc, da[kk], make_desc(q_tile + kk * 16 * L::RB, L::Q_BOX, 8 * L::RB, L::MODE));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    mbar_arrive(empty + 8 * stage);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + wl * 16 + g + 8 * h;
    if (key >= n) continue;
    bf16* vrow = dv_img + (size_t)key * dv;
#pragma unroll
    for (int c = 0; c < 8 * L::DVB; ++c)
      if (c * 8 < dv)
        *reinterpret_cast<__nv_bfloat162*>(vrow + c * 8 + 2 * t) =
            __floats2bfloat162_rn(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
    bf16* krow = dk_img + (size_t)key * dqk;
#pragma unroll
    for (int c = 0; c < DQK / 8; ++c)
      if (c * 8 < dqk)
        *reinterpret_cast<__nv_bfloat162*>(krow + c * 8 + 2 * t) =
            __floats2bfloat162_rn(dk_acc[4 * c + 2 * h], dk_acc[4 * c + 2 * h + 1]);
  }
}

// q, k, v and do come in through tensor maps over (B, n, d): boxes of (BOXC,
// BQ, 1) for q, (BOXC, 128, 1) for k, (64, 128, 1) for v and (64, BQ, 1)
// for do.
template <int DQK>
__global__ void __launch_bounds__(NT, 1)
attn_dkv_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv_out, int n, int dqk, int dv) {
  using L = Layout<DQK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::LSE);
  float* di_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::DI);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, kv_full = empty + 8 * STAGES;

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * BKB;
  const int boxes = (dv + 63) / 64;   // v and do boxes wholly past d_v are not loaded
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);   // the producer warp's lanes; lane 0's arrive expects the TMA bytes
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: stage j waits until the consumers have released tile j - STAGES
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, L::NBOX * L::K_BOX + boxes * V_BOX);
        for (int c = 0; c < L::NBOX; ++c)
          tma_load(base + L::K + c * L::K_BOX, &tk, c * L::BOXC, k0, b, kv_full);
        for (int c = 0; c < boxes; ++c)
          tma_load(base + L::V + c * V_BOX, &tv, 64 * c, k0, b, kv_full);
      }
      const float* lse_b = lse + (size_t)b * n;
      const float* di_b = di + (size_t)b * n;
      for (int j = 0, i0 = 0; i0 < n; ++j, i0 += L::BQ) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        // queries past n: lse +inf and di 0, so that p and ds are 0
        for (int r = lane; r < L::BQ; r += 32) {
          const bool ok = i0 + r < n;
          lse_s[s * L::BQ + r] = ok ? lse_b[i0 + r] * LOG2E : INFINITY;
          di_s[s * L::BQ + r] = ok ? di_b[i0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, L::Q_TILE + boxes * L::DO_BOX);
          for (int c = 0; c < L::NBOX; ++c)
            tma_load(base + L::Q + s * L::Q_TILE + c * L::Q_BOX, &tq, c * L::BOXC, i0, b,
                     full + 8 * s);
          for (int c = 0; c < boxes; ++c)
            tma_load(base + L::DO + (s * L::DVB + c) * L::DO_BOX, &tdo, 64 * c, i0, b,
                     full + 8 * s);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    consume_keys<DQK>(base, lse_s, di_s, cw, full, empty, kv_full, n, boxes,
                      dk + (size_t)b * n * dqk, dv_out + (size_t)b * n * dv, k0 + cw * 64, dqk,
                      dv);
  }
}

// ---------------------------------------------------------------------------
// float32 on FMA: 256 threads; p and ds of a (64 query x 64 key) tile go
// through shared memory; thread (ty, tx) accumulates dV for keys ty + 16a
// and value columns tx + 16c, dK for the same keys and d_qk columns tx + 16c
// (c < KC: 4 up to d_qk 64, 8 up to 128).

constexpr int BQ = 64;   // queries per tile
constexpr int BK = 64;   // keys per block
constexpr int PS = BK + 1;

template <int KC>
__global__ void __launch_bounds__(256, 1)
attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dk, float* __restrict__ dv_out, int n, int dqk, int dv) {
  extern __shared__ float smf[];
  const int QS = dqk + 1, VS = dv + 1;
  float* ks = smf;                 // [BK][QS]
  float* vs = ks + BK * QS;        // [BK][VS]
  float* qs = vs + BK * VS;        // [BQ][QS]
  float* dos = qs + BQ * QS;       // [BQ][VS]
  float* ps = dos + BQ * VS;       // [BQ][PS]
  float* dss = ps + BQ * PS;       // [BQ][PS]
  float* lse_s = dss + BQ * PS;    // [BQ]
  float* di_s = lse_s + BQ;        // [BQ]

  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)b * n * dqk;
  const float* kb = k + (size_t)b * n * dqk;
  const float* vb = v + (size_t)b * n * dv;
  const float* dob = dout + (size_t)b * n * dv;

  for (int i = tid; i < BK * dqk; i += 256) {
    const int r = i / dqk, c = i % dqk;
    ks[r * QS + c] = k0 + r < n ? kb[(size_t)(k0 + r) * dqk + c] : 0.f;
  }
  for (int i = tid; i < BK * dv; i += 256) {
    const int r = i / dv, c = i % dv;
    vs[r * VS + c] = k0 + r < n ? vb[(size_t)(k0 + r) * dv + c] : 0.f;
  }
  float dv_acc[4][16], dk_acc[4][KC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 16; ++c) dv_acc[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) dk_acc[a][c] = 0.f;
  }

  const int nq = (n + BQ - 1) / BQ;
  for (int it = 0; it < nq; ++it) {
    const int i0 = it * BQ;
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < BQ * dqk; i += 256) {
      const int r = i / dqk, c = i % dqk;
      qs[r * QS + c] = i0 + r < n ? qb[(size_t)(i0 + r) * dqk + c] : 0.f;
    }
    for (int i = tid; i < BQ * dv; i += 256) {
      const int r = i / dv, c = i % dv;
      dos[r * VS + c] = i0 + r < n ? dob[(size_t)(i0 + r) * dv + c] : 0.f;
    }
    if (tid < BQ) {
      const bool ok = i0 + tid < n;
      lse_s[tid] = ok ? lse[(size_t)b * n + i0 + tid] : INFINITY;
      di_s[tid] = ok ? di[(size_t)b * n + i0 + tid] : 0.f;
    }
    __syncthreads();

    // p and ds for queries ty + 16a, keys tx + 16c
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
      const float l = lse_s[r], dd = di_s[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[a][c] - l);
        ps[r * PS + tx + 16 * c] = pv;
        dss[r * PS + tx + 16 * c] = pv * (dp[a][c] - dd);
      }
    }
    __syncthreads();

    // dV[key][c] += sum_q p[q][key] do[q][c]; dK[key][d] += sum_q ds[q][key] q[q][d]
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[4], ov[16], qv[KC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[r * PS + ty + 16 * a];
        da[a] = dss[r * PS + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) ov[c] = tx + 16 * c < dv ? dos[r * VS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) qv[c] = tx + 16 * c < dqk ? qs[r * QS + tx + 16 * c] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 16; ++c) dv_acc[a][c] = fmaf(pa[a], ov[c], dv_acc[a][c]);
#pragma unroll
        for (int c = 0; c < KC; ++c) dk_acc[a][c] = fmaf(da[a], qv[c], dk_acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= n) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (tx + 16 * c < dv) dv_out[((size_t)b * n + key) * dv + tx + 16 * c] = dv_acc[a][c];
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (tx + 16 * c < dqk) dk[((size_t)b * n + key) * dqk + tx + 16 * c] = dk_acc[a][c];
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
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dk, void* dv_out, int B, int n,
                int dqk, int dv, cudaStream_t st) {
  using L = Layout<DQK>;
  constexpr CUtensorMapSwizzle swz_qk = L::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : L::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, n, dqk, L::BOXC, L::BQ, swz_qk) ||
      !tensor_map(&tk, k, B, n, dqk, L::BOXC, BKB, swz_qk) ||
      !tensor_map(&tv, v, B, n, dv, 64, BKB, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tdo, dout, B, n, dv, 64, L::BQ, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = L::BYTES;
  auto kernel = attn_dkv_bf16<DQK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BKB - 1) / BKB, B);
  kernel<<<grid, NT, smem, st>>>(tq, tk, tv, tdo, lse, di, static_cast<bf16*>(dk),
                                 static_cast<bf16*>(dv_out), n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k (B, n, dqk), v, dout (B, n, dv) in one dtype (0 = float32,
// 1 = bfloat16); lse, di (B, n) float32; dk (B, n, dqk) and dv_out
// (B, n, dv) in the input dtype; d_v <= 128 when d_qk > 64. Pointers
// 16-byte aligned. Returns a cudaError_t (0 = cudaSuccess,
// cudaErrorInvalidValue for shapes outside the contract); the launch is
// asynchronous on `stream`.
extern "C" int spatial_attention_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di, void* dk,
                                     void* dv_out, int B, int n, int dqk, int dv, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || n < 1 || dqk < 8 || dqk > 128 || dqk % 8 || dv < 8 ||
      dv > (dqk > 64 ? 128 : 256) || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 1) {
    if (dqk <= 16) return launch_bf16<16>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
    if (dqk <= 32) return launch_bf16<32>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
    if (dqk <= 64) return launch_bf16<64>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
    return launch_bf16<128>(q, k, v, dout, l, d, dk, dv_out, B, n, dqk, dv, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * BK * (dqk + 1) + 2 * BK * (dv + 1) + 2 * BQ * PS + 2 * BQ) * 4;
  auto kernel = dqk <= 64 ? attn_dkv_f32<4> : attn_dkv_f32<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BK - 1) / BK, 1, B);
  kernel<<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), l, d, static_cast<float*>(dk), static_cast<float*>(dv_out),
      n, dqk, dv);
  return static_cast<int>(cudaGetLastError());
}
