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
//   Optionally also db (Cout,) float32 = sum over n, h, w of dy[n][h][w][co],
//   the conv's bias gradient: float32 sums of the exact values of dy, bitwise
//   the same from run to run.
//
// What bounds it. Nine (N*H*W, Cin)^T (N*H*W, Cout) products: at B = 12 the
// trunk reduces over 49,152 pixels into 589,824 float32 outputs, ~58 GFLOP
// against ~53 MB in and out: operation-bound on the tensor cores (0.059 ms
// at 989 TFLOP/s). The TPU kernel carries the sum across its sequential
// grid; on Hopper blocks run in no order, and the outputs alone give only 12
// blocks of 128 x 128 channels x 3 taps, too few for 132 SMs.
//
// What this design does about that. The pixel reduction is split into S
// shares of the image-row segments (64 pixels of one row), S chosen by the
// caller so that the blocks fill the SMs; each block writes its float32
// partial sums to a scratch buffer (S, 3, 3, Cin, Cout), and dw_reduce adds
// the S partials in the order s = 0..S-1. No atomics, so the sum's order is
// fixed and the result deterministic. The bias gradient rides on the same
// blocks, each pixel's value read from the dy tile they stage anyway: the
// blocks of one output-channel tile and share stage the same dy segments
// (only x's row changes with ky and the input-channel tile), so G of them
// (G groups, see each route) split the share's segments between them and sum
// in a fixed order (per segment its pixels one by one into a segment sum,
// added to the group's), into S x G partial rows (S, G, Cout) after the dw
// partials, which dw_reduce adds in the order s = 0..S-1, g = 0..G-1. The
// caller picks one of two routes (the `route` argument):
//
//   0  float32 on FMA (never TF32): block (64 ci, 64 co, kernel row ky,
//      share s), each thread 4 ci x 4 co x 3 taps; per segment it stages dy
//      [64 px x 64 co] and the reflected x row h+ky-1 [66 px x 64 ci]. The
//      threads of ci row 0 hold each staged pixel's 64 dy values in registers
//      for the products; in the blocks of ci tile 0 and ky = 1 (G = 1) they
//      also sum db.
//   1  bf16 on wgmma, for Cin and Cout multiples of 8 and 16-byte aligned
//      pointers (the caller zero-pads other channel counts). Block (128 ci,
//      128 co, ky, s): M = ci, N = co, K = pixels, one K-stage a segment. One
//      producer thread (setmaxnreg 24) fills a ring of W_STAGES K-stages on
//      full and empty mbarriers by TMA over 4-D tensor maps (C, W, H, N): dy's
//      segment, 64 px x 128 co in two 64-channel boxes, and x's row hr =
//      reflect(h + ky - 1) from column w0 - 1 to w0 + 64, 66 px x 128 ci, in
//      the 128-byte swizzle; the producer picks hr, so the row reflect costs
//      nothing, and TMA's zero fill covers columns past W (dy is 0 there too).
//      Two consumer warpgroups (setmaxnreg 240), 64 ci each, hold a 64 x 128
//      float32 accumulator for each of the three taps kx (192 registers a
//      thread) and run wgmma.m64n128k16 with dy as the MN-major B operand from
//      shared memory and x as the A operand from registers: ldmatrix.trans
//      reads x's staged pixels at the offset kx, each lane giving its own
//      pixel's address, so the column reflect is in the address (column -1
//      reads column 1, column W reads column W - 2) and the three taps share
//      one staged row. Each wgmma is its own group and takes its A fragment
//      from a ring of four, reloaded once the product that read it retired.
//      db (the kernel's DB instance; the other compiles no trace of it, so
//      the call without db runs the code it ran before db existed: with one
//      instance and a runtime branch ptxas scheduled the consumers otherwise
//      and the call without db took 2.5% longer): in every block, the producer warpgroup's last two warps (idle
//      otherwise), four channels and half the pixels a thread, sum every
//      G-th staged dy segment (G = 3 x the ci tiles: the block of ci tile t
//      and row ky takes the share's segments j with j % G = 3 t + ky) in its
//      swizzle, and join every stage's empty barrier, so no stage is refilled
//      before they have read it. Summing each segment on one block in G keeps
//      the summing warps, whose loads wait one after the other in the
//      producer's 24 registers, well ahead of the consumers.
//      At (12, 64, 64, 256): 12 output tiles x S = 11 = 132 blocks, one wave.

#include <cuda.h>   // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CI_T = 64;      // float32 route: input channels per block
constexpr int CO_T = 64;      // float32 route: output channels per block
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
               float* __restrict__ part, float* __restrict__ part_db, int N, int H, int W,
               int Cin, int Cout, int S) {
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
  // db: ci row 0 of the blocks of ci tile 0 and kernel row 1, output
  // channels co0 + 4 tc .. + 3 (the 16 threads together hold all 64), each
  // segment's 64 pixels one by one into a segment sum, added to the share's
  const bool sums_db = part_db != nullptr && ci0 == 0 && ky == 1 && tr == 0;
  float db_share[4] = {0.f, 0.f, 0.f, 0.f};

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
    float db_seg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int p = 0; p < SEG; ++p) {
      const float4 d = *reinterpret_cast<const float4*>(dys + p * CO_T + tc * 4);
      if (sums_db) {
        db_seg[0] += d.x;
        db_seg[1] += d.y;
        db_seg[2] += d.z;
        db_seg[3] += d.w;
      }
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
#pragma unroll
    for (int b = 0; b < 4; ++b) db_share[b] += db_seg[b];
    __syncthreads();
  }

  if (sums_db) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (co0 + tc * 4 + b < Cout) part_db[(size_t)s * Cout + co0 + tc * 4 + b] = db_share[b];
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
// bf16 on wgmma. Shared memory: a ring of W_STAGES K-stages, each dy's two
// 64-channel boxes (64 rows of 128 bytes) then x's two (66 rows of 128 bytes,
// each box from a 1024-byte boundary), all in the 128-byte swizzle that TMA
// writes (the 16-byte chunk bits of an address XOR the bits just above 128
// bytes); then the full and empty barriers.

constexpr int W_CI = 128;                  // input channels per block: two consumers of 64
constexpr int W_CO = 128;                  // output channels per block
constexpr int W_STAGES = 6;
constexpr int W_THREADS = 384;             // producer + two consumers
constexpr int W_CONSUMERS = 256;
constexpr int W_DB_THREADS = 64;           // the producer warpgroup's last two warps
constexpr int W_DYBOX = SEG * 128;         // 64 pixels x 64 channels
constexpr int W_XBOX = 9 * 1024;           // 66 pixels x 64 channels (8448 bytes), to 1024
constexpr int W_XOFF = 2 * W_DYBOX;
constexpr int W_STAGE = W_XOFF + 2 * W_XBOX;
constexpr int W_BAR = W_STAGES * W_STAGE;
constexpr int W_SMEM = W_BAR + 16 * W_STAGES + 1024;        // + slack to align the base

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

// One box of a 4-D tensor map (coordinates innermost first) to shared
// memory, its bytes counted on `bar`; what lies outside the tensor reads as
// zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Four transposed 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Stored S[k][m], each register holds (S[2t][g], S[2t+1][g]) of
// its matrix: with matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
// (k 8-15, m 8-15) that is one warp's A fragment of a wgmma (rows 16w..16w+15).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// d (64 x 128, float32) += a (64 x 16, bf16 registers) b (16 x 128, shared,
// MN-major: two 64-column boxes LBO apart).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The shared address of the 16-byte chunk `chunk` (8 input channels) of the
// staged x pixel in slot q (slot q holds column w0 - 1 + q; the 128-byte
// swizzle XORs the chunk with the slot's low three bits), with the column
// reflect: slot qlo (column -1) reads slot 2 (column 1), slot qhi (column W)
// reads slot qhi - 2 (column W - 2).
__device__ __forceinline__ uint32_t x_chunk(uint32_t xt, int q, int qlo, int qhi, int chunk) {
  q = q == qlo ? 2 : q == qhi ? qhi - 2 : q;
  return xt + q * 128 + ((chunk ^ (q & 7)) << 4);
}

// One consumer warpgroup: input channels ci0 + 64 cw .. + 63 of the block,
// all 128 output channels, the three taps of kernel row ky, over the
// segments [lo, hi). Segment j is read from ring stage j % W_STAGES once its
// full barrier completes, and released on its empty barrier once the last
// wgmma that reads it has retired (one k16 step into the next segment).
// Each wgmma is its own group, its A fragment one of a ring of four, so that
// a fragment is reloaded only once the product that read it has retired
// while three products stay in flight (two sets of the three taps'
// fragments, 24 registers beside the accumulators' 192, made ptxas
// serialise every wgmma: C7512).
// Accumulator layout (wgmma's): warp w of the group holds input channels 16w
// + g and 16w + g + 8 (g = lane / 4), register 4c + e output channel 8c + 2t
// + (e & 1) (t = lane % 4) of row g + 8 (e >> 1).
__device__ __forceinline__ void dw_consume(uint32_t base, uint32_t full, uint32_t empty,
                                           long long lo, long long hi, int segs_w, int W,
                                           int cw, int ky, int ci0, int co0,
                                           float* __restrict__ part_s, int Cin, int Cout) {
  const int lane = threadIdx.x % 32;
  const int wl = (threadIdx.x / 32) % 4;
  const int mat = lane >> 3;                          // this lane's ldmatrix matrix
  const int krow = (mat >> 1) * 8 + (lane & 7);       // its pixel within a k16 step
  const int chunk = 2 * wl + (mat & 1);               // its 8 input channels
  float acc[3][64];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[kx][i] = 0.f;
  uint32_t a[4][4];   // a ring of A fragments, one a product

  for (long long seg = lo; seg < hi; ++seg) {
    const int j = (int)(seg - lo);
    const int s = j % W_STAGES;
    const int w0 = (int)(seg % segs_w) * SEG;
    const int qlo = w0 == 0 ? 0 : -1, qhi = W - w0 + 1;
    mbar_wait(full + 8 * s, (j / W_STAGES) & 1);
    const uint32_t dyt = base + s * W_STAGE;
    const uint32_t xt = dyt + W_XOFF + cw * W_XBOX;
#pragma unroll
    for (int kk = 0; kk < SEG / 16; ++kk) {
      // B: dy's pixels 16kk..16kk+15 (K) x 128 output channels (N), MN-major
      const uint64_t db = make_desc(dyt + kk * 2048, W_DYBOX, 1024, 1);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // product 12j + 3kk + kx; 12 a segment, so its slot is static
        const int r = (3 * kk + kx) % 4;
        wgmma_wait<3>();   // product 12j + 3kk + kx - 4, the last to read a[r], has retired
        // and with it (at kk 1, kx 0) the last product of segment j - 1
        if (kk == 1 && kx == 0 && j > 0) mbar_arrive(empty + 8 * ((j - 1) % W_STAGES));
        ldsm_x4_trans(a[r], x_chunk(xt, kk * 16 + kx + krow, qlo, qhi, chunk));
        wgmma_fence();
        wgmma_rs_n128(acc[kx], a[r], db);
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(acc[kx][i]);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* dst = part_s + (size_t)(ky * 3 + kx) * Cin * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + cw * 64 + wl * 16 + g + 8 * h;
      if (ci >= Cin) continue;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int co = co0 + 8 * c + 2 * t;
        if (co < Cout)   // Cout is a multiple of 8, so co + 1 < Cout too
          *reinterpret_cast<float2*>(dst + (size_t)ci * Cout + co) =
              make_float2(acc[kx][4 * c + 2 * h], acc[kx][4 * c + 2 * h + 1]);
      }
    }
  }
}

// The bias gradient's partial of group g of G, on the producer warpgroup's
// last W_DB_THREADS (two warps, one a 64-channel box of dy): lane l of warp
// `box` sums output channels co0 + 64 box + 4 (l % 16) .. + 3 over pixels
// 32 (l / 16) .. + 31 of each segment j < segs of the share with j % G = g
// (one 8-byte load a pixel, in the 128-byte swizzle; TMA's zero fill past W
// adds nothing), pixel by pixel into a segment sum, each segment sum added
// to the half's; at the end the two halves' sums (first half + second) give
// the partial. Every segment j is waited for on its ring stage's full
// barrier and released on its empty barrier, which counts these threads
// beside the consumers. The loads are volatile, so they stay between the two
// barriers.
__device__ __forceinline__ void dw_sum_db(uint32_t base, uint32_t full, uint32_t empty,
                                          int segs, int g, int G, int co0,
                                          float* __restrict__ part_db_sg, int Cout) {
  const int u = threadIdx.x - (128 - W_DB_THREADS);
  const int box = u >> 5, half = (u >> 4) & 1, quad = u & 15, chunk = quad >> 1;
  const uint32_t col = base + box * W_DYBOX + half * 32 * 128 + (quad & 1) * 8;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0, next = g; j < segs; ++j) {
    const int st = j % W_STAGES;
    mbar_wait(full + 8 * st, (j / W_STAGES) & 1);
    if (j == next) {
      next += G;
      const uint32_t rows = col + st * W_STAGE;
      float seg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int p = 0; p < SEG / 2; ++p) {   // row 32 half + p; its swizzle row is p % 8
        uint32_t lo, hi;
        asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                     : "=r"(lo), "=r"(hi)
                     : "r"(rows + p * 128 + ((chunk ^ (p & 7)) << 4)));
        seg[0] += __uint_as_float(lo << 16);
        seg[1] += __uint_as_float(lo & 0xffff0000u);
        seg[2] += __uint_as_float(hi << 16);
        seg[3] += __uint_as_float(hi & 0xffff0000u);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) part[b] += seg[b];
    }
    mbar_arrive(empty + 8 * st);
  }
  const int co = co0 + 64 * box + 4 * quad;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float other = __shfl_xor_sync(0xffffffffu, part[b], 16);
    // Cout is a multiple of 8, so co + 3 < Cout where co < Cout
    if (half == 0 && co < Cout) part_db_sg[co + b] = part[b] + other;
  }
}

// x comes in through a 4-D tensor map over (Cin, W, H, N) in boxes of (64, 66,
// 1, 1), dy through one over (Cout, W, H, N) in boxes of (64, 64, 1, 1).
// Block (ci tile, co tile, 3 s + ky). DB: also the bias gradient's partials
// into part_db (S, G, Cout), G = 3 x the ci tiles.
template <bool DB>
__global__ void __launch_bounds__(W_THREADS, 1)
dw_partial_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                 float* __restrict__ part, float* __restrict__ part_db, int N, int H, int W,
                 int Cin, int Cout, int S) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + W_BAR, empty = full + 8 * W_STAGES;
  const int ci0 = blockIdx.x * W_CI, co0 = blockIdx.y * W_CO;
  const int ky = blockIdx.z % 3, s = blockIdx.z / 3;
  const int segs_w = (W + SEG - 1) / SEG;
  long long lo, hi;
  split_range((long long)N * H * segs_w, s, S, &lo, &hi);

  if (threadIdx.x == 0) {
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, W_CONSUMERS + (DB ? W_DB_THREADS : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles' paths must never meet again (not even in a shared trap
  // block), or setmaxnreg no longer sets the consumers' register budget.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: segment j waits until the consumers have released j - W_STAGES
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // boxes wholly past Cin or Cout are not loaded: they would only feed
      // accumulator rows or columns that are never stored
      const bool x2 = ci0 + 64 < Cin, dy2 = co0 + 64 < Cout;
      const int bytes = (dy2 ? 2 : 1) * W_DYBOX + (x2 ? 2 : 1) * XQ * 128;
      for (long long seg = lo; seg < hi; ++seg) {
        const int j = (int)(seg - lo), st = j % W_STAGES;
        const int w0 = (int)(seg % segs_w) * SEG;
        const int h = (int)((seg / segs_w) % H);
        const int n = (int)(seg / ((long long)segs_w * H));
        const int hr = reflect_index(h + ky - 1, H);
        const uint32_t stage = base + st * W_STAGE, bar = full + 8 * st;
        mbar_wait(empty + 8 * st, ((j / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, bytes);
        tma_load_4d(stage, &tdy, co0, w0, h, n, bar);
        if (dy2) tma_load_4d(stage + W_DYBOX, &tdy, co0 + 64, w0, h, n, bar);
        tma_load_4d(stage + W_XOFF, &tx, ci0, w0 - 1, hr, n, bar);
        if (x2) tma_load_4d(stage + W_XOFF + W_XBOX, &tx, ci0 + 64, w0 - 1, hr, n, bar);
      }
    } else if (DB && threadIdx.x >= 128 - W_DB_THREADS) {
      const int G = 3 * gridDim.x, g = 3 * blockIdx.x + ky;
      dw_sum_db(base, full, empty, (int)(hi - lo), g, G, co0,
                part_db + ((size_t)s * G + g) * Cout, Cout);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    dw_consume(base, full, empty, lo, hi, segs_w, W, wg - 1, ky, ci0, co0,
               part + (size_t)s * 9 * Cin * Cout, Cin, Cout);
  }
}

// ---------------------------------------------------------------------------

// db[i] for i < Cout where db is given (first, so that its longer sums start
// with the first wave), then dw[i - Cout] (or dw[i]) for the next count: dw
// the S partials added in the order s = 0..S-1, db the S x G partials (after
// the dw ones in part) in the order s, then g.
__global__ void dw_reduce(const float* __restrict__ part, float* __restrict__ dw,
                          float* __restrict__ db, long long count, int Cout, int S, int G) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (db != nullptr) {
    if (i < Cout) {
      const float* pdb = part + (size_t)S * count;
      float v = 0.f;
      for (int sg = 0; sg < S * G; ++sg) v += pdb[(size_t)sg * Cout + i];
      db[i] = v;
      return;
    }
    i -= Cout;
  }
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[(size_t)s * count + i];
  dw[i] = v;
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

// A 4-D tensor map over a contiguous bf16 NHWC tensor, dims (C, W, H, N), in
// boxes of `box`, in the 128-byte swizzle; what lies outside the tensor reads
// as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int N, int H, int W, int C,
                const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};   // bytes
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* x, const void* dy, float* part, float* part_db, int N, int H,
                 int W, int Cin, int Cout, int S, cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  if (Cin % 8 || Cout % 8 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tdy;
  const cuuint32_t x_box[4] = {64, XQ, 1, 1};
  const cuuint32_t dy_box[4] = {64, SEG, 1, 1};
  if (!tensor_map(&tx, x, N, H, W, Cin, x_box) || !tensor_map(&tdy, dy, N, H, W, Cout, dy_box))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, once: the kernel's shared memory
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  if (!ready[dev]) {
    for (const void* fn : {reinterpret_cast<const void*>(dw_partial_wgmma<false>),
                           reinterpret_cast<const void*>(dw_partial_wgmma<true>)}) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ready[dev] = true;
  }
  const dim3 grid((Cin + W_CI - 1) / W_CI, (Cout + W_CO - 1) / W_CO, 3 * S);
  if (part_db != nullptr)
    dw_partial_wgmma<true><<<grid, W_THREADS, W_SMEM, st>>>(tx, tdy, part, part_db, N, H, W, Cin,
                                                            Cout, S);
  else
    dw_partial_wgmma<false><<<grid, W_THREADS, W_SMEM, st>>>(tx, tdy, part, nullptr, N, H, W,
                                                             Cin, Cout, S);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x (N,H,W,Cin), dy (N,H,W,Cout) in one dtype; route: 0 float32 (FMA), 1
// bf16 (wgmma + TMA; Cin, Cout multiples of 8, 16-byte aligned pointers).
// part: float32 scratch of S * 9 * Cin * Cout, and S * G * Cout more after
// them where db is given (G = 1 on route 0, 3 * ceil(Cin / 128) on route 1);
// dw (3,3,Cin,Cout) float32; db (Cout,) float32, or null for no bias
// gradient.
// Returns a cudaError_t after the two launches (0 = cudaSuccess,
// cudaErrorInvalidValue for a shape or route the call does not take); both
// are asynchronous on `stream`.
extern "C" int reflect_conv3x3_dw(const void* x, const void* dy, void* part,
                                  void* dw, void* db, int N, int H, int W, int Cin,
                                  int Cout, int S, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || 3LL * S > 65535 || N < 1 || H < 2 || W < 2 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  const long long count = 9LL * Cin * Cout;
  float* p_db = db != nullptr ? p + S * count : nullptr;
  if (route == 0) {
    const dim3 grid((Cin + CI_T - 1) / CI_T, (Cout + CO_T - 1) / CO_T, 3 * S);
    dw_partial_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), p, p_db, N, H, W, Cin,
        Cout, S);
  } else if (route == 1) {
    const int err = launch_wgmma(x, dy, p, p_db, N, H, W, Cin, Cout, S, st);
    if (err != 0) return err;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long reduced = count + (db != nullptr ? Cout : 0);
  const int groups = route == 1 ? 3 * ((Cin + W_CI - 1) / W_CI) : 1;
  dw_reduce<<<(unsigned)((reduced + 255) / 256), 256, 0, st>>>(
      p, static_cast<float*>(dw), static_cast<float*>(db), count, Cout, S, groups);
  return static_cast<int>(cudaGetLastError());
}
