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
// What bounds it. At B = 12 one trunk conv is 2*9*12*64*64*256*256 ~= 58.0
// GFLOP against ~51 MB of bf16 activations read and written: about 1150
// FLOP per byte, far above the H100's ~295 FLOP/byte ridge for bf16. The
// conv is operation-bound on the tensor cores (0.059 ms at 989 TFLOP/s).
//
// The caller picks one of two routes (the `route` argument):
//
//   0  float32 on FMA, never TF32 (that would break the exact float32
//      contract). One block owns an 8x16 output tile and 64 output channels;
//      each thread keeps 8 pixels x 4 channels of accumulators and reads,
//      per (ci, ky), 10 halo values and 3 float4 weight vectors from shared
//      memory for 96 FMAs. The halo's channel stride is padded (KC + 1) so
//      the two pixel groups of a warp hit different banks; the reflect is
//      done on the index while staging.
//   1  bf16 on wgmma, for Cin and Cout multiples of 8 and 16-byte aligned
//      pointers (the caller zero-pads other channel counts). An implicit
//      GEMM, M = output pixels, N = output channels, K = 9 taps x Cin,
//      persistent: one block per SM walks the tiles of 128 output pixels
//      (two image rows, each a segment of 64 pixels) x 256 output channels.
//      One producer thread (setmaxnreg 40) issues every TMA load on full
//      and empty mbarriers. For each 64-channel chunk of Cin it loads an x
//      stage, the four input rows reflect(y0 - 1) .. reflect(y0 + 2) that
//      the tile's output rows y0, y0 + 1 read, each 66 pixels from column
//      x0 - 1 (a 4-D tensor map over x (Cin, W, H, N); the producer picks
//      the rows, so the row reflect costs nothing, and TMA's zero fill
//      covers columns outside the image), then nine w stages, one a tap,
//      w[tap][ci0 .. ci0 + 63][co0 .. co0 + 255] in four 64-channel boxes
//      (a 3-D map over w (Cout, Cin, 9)): an MN-major B operand. A ring of
//      two x stages and three w stages. Two consumer warpgroups (setmaxnreg
//      232), one output row each, hold a 64 x 256 float32 accumulator (128
//      registers a thread) and run wgmma.m64n256k16 with w from shared
//      memory and x as the A operand from registers: a non-transposed
//      ldmatrix reads 16 pixels x 16 channels of staged row ky, each lane
//      giving its own pixel's slot p + kx, so the column reflect is in the
//      address (the slot of column -1 reads column 1, that of column W
//      reads column W - 2) and the nine taps share one x stage. Each wgmma
//      is its own group and takes its A fragment from a ring of four,
//      reloaded once the product that read it has retired. The epilogue
//      adds the float32 bias (staged in shared memory before the K loop),
//      casts each value once to bf16, stages each output row in shared
//      memory (consumer 0's in the tile's last x stage, consumer 1's in a
//      buffer of its own) and stores it by TMA, which writes y while the
//      next tile's products run: stored straight from the registers, the
//      same bytes took a quarter of the time at the trunk shape, since every
//      block stored at once and its tensor cores waited. At (12, 64, 64,
//      256): 384 tiles, 2.9 a block.
// No atomics: both routes give the same bits from run to run.

#include <cuda.h>   // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Route 0: float32 on FMA

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
// Route 1: bf16 on wgmma. Shared memory: a ring of F_XSTAGES x stages (four
// staged rows of 66 pixels x 64 channels, each from a 1024-byte boundary),
// then a ring of F_WSTAGES w stages (64 input x 256 output channels of one
// tap, four 64-output-channel boxes of 64 rows of 128 bytes), then consumer
// 1's output row (64 pixels x 256 channels, four 64-channel boxes), all in
// the 128-byte swizzle that TMA reads and writes (the 16-byte chunk bits of
// an address XOR the bits just above 128 bytes); then each consumer's two
// bias slots and the full and empty barriers. Consumer 0 stages its output
// row in the tile's last x stage.

constexpr int F_SEG = 64;                   // output pixels of an image row a consumer owns
constexpr int F_XQ = F_SEG + 2;             // staged columns x0 - 1 .. x0 + 64
constexpr int F_BN = 256;                   // output channels per tile
constexpr int F_BK = 64;                    // input channels per chunk: one 128-byte row
constexpr int F_XSTAGES = 2;
constexpr int F_WSTAGES = 3;
constexpr int F_THREADS = 384;              // producer + two consumers
constexpr int F_CONSUMERS = 256;
constexpr int F_XROW = 9 * 1024;            // one staged row (8448 bytes), to 1024
constexpr int F_XSTAGE = 4 * F_XROW;
constexpr int F_WBOX = F_BK * 128;          // 64 input x 64 output channels
constexpr int F_YBOX = F_SEG * 128;         // 64 pixels x 64 output channels
constexpr int F_WSTAGE = 4 * F_WBOX;
constexpr int F_WOFF = F_XSTAGES * F_XSTAGE;
constexpr int F_Y1 = F_WOFF + F_WSTAGES * F_WSTAGE;
constexpr int F_BIAS = F_Y1 + 4 * F_YBOX;
constexpr int F_BAR = F_BIAS + 2 * 2 * F_BN * 4;   // two slots a consumer
constexpr int F_SMEM = F_BAR + 8 * 2 * (F_XSTAGES + F_WSTAGES) + 1024;   // + slack to align
static_assert(4 * F_YBOX <= F_XSTAGE, "consumer 0 stages its output row in an x stage");
static_assert(F_SMEM <= 232448, "more shared memory than a Hopper block can have");

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

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
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

// One box of shared memory to a 4-D tensor map, in this thread's bulk group;
// what lies outside the tensor is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's bulk stores have written device memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Until the `count` threads of named barrier `id` have arrived.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` without waiting.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and each register holds (S[g][2t], S[g][2t+1]) of its matrix (g =
// l / 4, t = l % 4). With matrices (pixels 0-7, channels 0-7), (pixels 8-15,
// channels 0-7), (pixels 0-7, channels 8-15), (pixels 8-15, channels 8-15)
// that is one warp's A fragment of a wgmma (rows 16w..16w+15).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 256, float32) += a (64 x 16, bf16 registers) b (16 x 256, shared,
// MN-major: four 64-column boxes LBO apart).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
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

// A block's tile: image n, output rows y0 and y0 + 1, pixels x0 .. x0 + 63,
// output channels co0 .. co0 + 255. Tile t of N * ceil(H / 2) * ceil(W /
// 64) * ceil(Cout / 256), the output-channel block fastest.
struct Tile {
  int n, y0, x0, co0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W, int Cout) {
  const int cblocks = (Cout + F_BN - 1) / F_BN, tiles_w = (W + F_SEG - 1) / F_SEG;
  const int tiles_h = (H + 1) / 2;
  Tile r;
  r.co0 = (t % cblocks) * F_BN;
  t /= cblocks;
  r.x0 = (t % tiles_w) * F_SEG;
  t /= tiles_w;
  r.y0 = (t % tiles_h) * 2;
  r.n = t / tiles_h;
  return r;
}

// One consumer warpgroup: output row y0 + cw of each of the block's tiles.
// x stage gx (one a chunk, counted across tiles) is read from ring slot gx %
// F_XSTAGES, w stage gw (one a tap) from gw % F_WSTAGES, each once its full
// barrier completes. Products are numbered in issue order; the four of a
// tap are its k16 steps, product p takes A fragment a[p % 4], and before it
// loads that fragment it waits until product p - 4 has retired: at the
// fourth step of a tap that is the last product of the tap before, whose w
// stage (and at tap 0, whose chunk's x stage) it then releases on the empty
// barrier. Accumulator layout (wgmma's): warp w of the group holds pixels
// 16w + g and 16w + g + 8 (g = lane / 4), register 4c + e output channel 8c
// + 2t + (e & 1) (t = lane % 4) of pixel g + 8 (e >> 1).
__device__ __forceinline__ void fwd_consume(uint32_t base, unsigned char* sbase,
                                            const CUtensorMap* ty, int tiles, int chunks, int cw,
                                            const float* __restrict__ bias, int H, int W,
                                            int Cout) {
  const uint32_t xfull = base + F_BAR, xempty = xfull + 8 * F_XSTAGES;
  const uint32_t wfull = xempty + 8 * F_XSTAGES, wempty = wfull + 8 * F_WSTAGES;
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int wl = tid / 32;
  const int prow = 16 * wl + (lane & 15);   // this lane's ldmatrix pixel
  const int hi = lane >> 4;                  // and its 8 channels of a k16 step
  float* bias_s = reinterpret_cast<float*>(sbase + F_BIAS) + cw * 2 * F_BN;
  int gx = 0, gw = 0, it = 0;
  int held = -1;   // consumer 0: the x stage its last output row is stored from
  for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x, ++it) {
    const Tile tl = tile_of(ti, H, W, Cout);
    // the tile's bias; the slot of two tiles back is free, since every thread
    // of the group passed the last tile's barrier after its epilogue
    float* bs = bias_s + (it & 1) * F_BN;
    for (int i = tid; i < F_BN; i += 128) bs[i] = tl.co0 + i < Cout ? bias[tl.co0 + i] : 0.f;
    bar_sync(1 + cw, 128);
    // the staged slot (column x0 - 1 + q) of this lane's pixel at each tap
    // kx, with the column reflect
    const int qlo = tl.x0 == 0 ? 0 : -1, qhi = W - tl.x0 + 1;
    uint32_t qrow[3];
    int qsw[3];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      int q = prow + kx;
      q = q == qlo ? 2 : q == qhi ? qhi - 2 : q;
      qrow[kx] = q * 128;
      qsw[kx] = q & 7;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a[4][4];   // a ring of A fragments, one a product

    for (int c = 0; c < chunks; ++c, ++gx) {
      const int xs = gx % F_XSTAGES;
      mbar_wait(xfull + 8 * xs, (gx / F_XSTAGES) & 1);
      const uint32_t xt = base + xs * F_XSTAGE + cw * F_XROW;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++gw) {
        const int ky = tap / 3, kx = tap % 3;
        const int ws = gw % F_WSTAGES;
        mbar_wait(wfull + 8 * ws, (gw / F_WSTAGES) & 1);
        const uint32_t wt = base + F_WOFF + ws * F_WSTAGE;
        const uint32_t xr = xt + ky * F_XROW + qrow[kx];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_wait<3>();   // product p - 4, the last to read a[kk], has retired
          if (kk == 3 && (c > 0 || tap > 0)) {
            mbar_arrive(wempty + 8 * ((gw - 1) % F_WSTAGES));
            if (tap == 0) mbar_arrive(xempty + 8 * ((gx - 1) % F_XSTAGES));
          }
          if (kk == 3 && tap == 4 && c == 0 && held >= 0) {
            // the TMA has long read the last tile's row out of x stage
            // `held`: release it for the whole group
            if (tid == 0) {
              bulk_wait_read();
              mbar_arrive(xempty + 8 * held, 128);
            }
            held = -1;
          }
          ldsm_x4(a[kk], xr + (((2 * kk + hi) ^ qsw[kx]) << 4));
          wgmma_fence();
          // B: input channels 16kk .. 16kk + 15 (K) x 256 output channels (N)
          wgmma_rs_n256(acc, a[kk], make_desc(wt + kk * 2048, F_WBOX, 1024, 1));
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    mbar_arrive(wempty + 8 * ((gw - 1) % F_WSTAGES));

    // epilogue begin
    // Consumer 0 stages its output row (64 pixels x 256 channels, four
    // 64-channel boxes in the 128-byte swizzle) in the tile's last x stage
    // once consumer 1 has read that, consumer 1 in its own buffer once the
    // TMA has read its last row out of it; one thread of each stores the row
    // by TMA, which clips what lies past W, H or Cout, and does not wait for
    // it. Consumer 1 releases the x stage now, consumer 0 in the next tile.
    const int xs = (gx - 1) % F_XSTAGES;
    uint32_t out;
    if (cw == 0) {
      bar_sync(3, F_CONSUMERS);
      out = base + xs * F_XSTAGE;
      held = xs;
    } else {
      bar_arrive(3, F_CONSUMERS);
      mbar_arrive(xempty + 8 * xs);
      if (tid == 0) bulk_wait_read();
      bar_sync(2, 128);
      out = base + F_Y1;
    }
    const int oy = tl.y0 + cw;
    if (oy < H) {
      const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * wl + g8 + 8 * h;   // p & 7 == g8
        const uint32_t row = out + p * 128 + 4 * t;
#pragma unroll
        for (int c = 0; c < F_BN / 8; ++c) {
          const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * c + 2 * t);
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * c + 2 * h] + bv.x,
                                                   acc[4 * c + 2 * h + 1] + bv.y);
          st_shared(row + (c / 8) * F_YBOX + (((c % 8) ^ g8) << 4),
                    *reinterpret_cast<uint32_t*>(&v));
        }
      }
      fence_proxy_async();
    }
    bar_sync(1 + cw, 128);
    if (tid == 0 && oy < H) {
      for (int j = 0; j < 4 && tl.co0 + 64 * j < Cout; ++j)
        tma_store_4d(ty, out + j * F_YBOX, tl.co0 + 64 * j, tl.x0, oy, tl.n);
      bulk_commit();
    }
    // epilogue end
  }
  if (tid == 0) bulk_wait();
}

// x comes in through a 4-D tensor map over (Cin, W, H, N) in boxes of (64,
// 66, 1, 1), w through a 3-D map over (Cout, Cin, 9) in boxes of (64, 64,
// 1), and y goes out through one over (Cout, W, H, N) in boxes of (64, 64,
// 1, 1). Persistent: block b takes tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(F_THREADS, 1)
fwd_main_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap ty, const float* __restrict__ bias,
               int tiles, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t xfull = base + F_BAR, xempty = xfull + 8 * F_XSTAGES;
  const uint32_t wfull = xempty + 8 * F_XSTAGES, wempty = wfull + 8 * F_WSTAGES;
  const int chunks = (Cin + F_BK - 1) / F_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_XSTAGES; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, F_CONSUMERS);
    }
    for (int s = 0; s < F_WSTAGES; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, F_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: a stage waits until the consumers have released the one a
    // ring's length before it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int gx = 0, gw = 0;
      for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
        const Tile tl = tile_of(ti, H, W, Cout);
        // boxes wholly past Cout are not loaded: they would only feed
        // accumulator columns that are never stored
        const int wboxes = min(4, (Cout - tl.co0 + 63) / 64);
        for (int c = 0; c < chunks; ++c, ++gx) {
          const int xs = gx % F_XSTAGES;
          const uint32_t xbar = xfull + 8 * xs, xdst = base + xs * F_XSTAGE;
          mbar_wait(xempty + 8 * xs, ((gx / F_XSTAGES) & 1) ^ 1);
          mbar_expect_tx(xbar, 4 * F_XQ * 128);
          // the four input rows of output rows y0, y0 + 1: the row reflect
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_4d(xdst + i * F_XROW, &tx, c * F_BK, tl.x0 - 1,
                        reflect_index(tl.y0 - 1 + i, H), tl.n, xbar);
          for (int tap = 0; tap < 9; ++tap, ++gw) {
            const int ws = gw % F_WSTAGES;
            const uint32_t wbar = wfull + 8 * ws, wdst = base + F_WOFF + ws * F_WSTAGE;
            mbar_wait(wempty + 8 * ws, ((gw / F_WSTAGES) & 1) ^ 1);
            mbar_expect_tx(wbar, wboxes * F_WBOX);
            for (int j = 0; j < wboxes; ++j)
              tma_load_3d(wdst + j * F_WBOX, &tw, tl.co0 + 64 * j, c * F_BK, tap, wbar);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    fwd_consume(base, smem_raw + (base - raw), &ty, tiles, chunks, wg - 1, bias, H, W, Cout);
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

int launch_wgmma(const void* x, const void* w, const float* b, void* y, int N, int H, int W,
                 int Cin, int Cout, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (Cin % 8 || Cout % 8 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw, ty;
  const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint32_t x_box[4] = {F_BK, F_XQ, 1, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint32_t w_box[3] = {64, F_BK, 1};
  const cuuint64_t y_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint32_t y_box[4] = {64, F_SEG, 1, 1};
  if (!tensor_map(&tx, x, 4, x_dims, x_box) || !tensor_map(&tw, w, 3, w_dims, w_box) ||
      !tensor_map(&ty, y, 4, y_dims, y_box))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, once: the kernel's shared memory and one block per SM
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(fwd_main_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long tiles =
      (long)N * ((H + 1) / 2) * ((W + F_SEG - 1) / F_SEG) * ((Cout + F_BN - 1) / F_BN);
  if (tiles > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  fwd_main_wgmma<<<(unsigned)(tiles < sms[dev] ? tiles : sms[dev]), F_THREADS, F_SMEM, s>>>(
      tx, tw, ty, b, (int)tiles, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N,H,W,Cin), w (3,3,Cin,Cout) in x's dtype, b (Cout,) float32, y
// (N,H,W,Cout) in x's dtype. route: 0 float32 (FMA), 1 bf16 (wgmma + TMA;
// Cin, Cout multiples of 8, 16-byte aligned x, w and y). Returns a
// cudaError_t after the launch (0 = cudaSuccess, cudaErrorInvalidValue for a
// shape or route the call does not take); the launch is asynchronous on
// `stream`.
extern "C" int reflect_conv3x3_forward(const void* x, const void* w, const void* b, void* y,
                                       int N, int H, int W, int Cin, int Cout, int route,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || H < 2 || W < 2 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bias = static_cast<const float*>(b);
  if (route == 1) return launch_wgmma(x, w, bias, y, N, H, W, Cin, Cout, s);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Cout + CO_T - 1) / CO_T, N);
  reflect_conv3x3_f32<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w), bias,
                                               static_cast<float*>(y), H, W, Cin, Cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
