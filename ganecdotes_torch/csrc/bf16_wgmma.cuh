// The bfloat16 implicit-GEMM main loop that both StyledConv kernels run on
// bf16 activations (styled_conv.cu: the 9 taps of a 3x3 'same' conv;
// styled_up_conv.cu: the 4, 2, 2 or 1 taps of a phase class of the
// stride-2 transposed conv), built from what Hopper added: TMA, mbarriers,
// a producer and consumer warpgroups running wgmma. The float32 kernels run
// tf32x3.cuh instead.
//
// A block owns a BM x BN tile of out[m, n] = sum over (tap, c) of
// A_tap[m, c] * W_tap[n, c]: row m of A_tap is the input pixel that output
// pixel m reads through the tap (zero outside the image), W_tap the tap's
// (Cout, Cin) slice of the (3, 3, Cout, Cin) weights, k contiguous.
//
// Arithmetic: wgmma.mma_async m64nBNk16, bf16 A and B from shared memory,
// fp32 accumulators in registers: the bf16 operands the JAX kernel feeds
// its MXU (ganecdotes_tpu/ops/modulated_conv_pallas.py:166-184, with
// preferred_element_type float32). The kernels' epilogues stay in fp32 and
// round once, on the store.
//
// Bound: operations (2 Cin Cout flops a pixel and tap), but each
// 64-channel stage of a BM x BN tile reads 128 (BM + BN) bytes from L2 for
// 2 BM BN 64 flops: 64 flops a byte at 128 x 128, 85 at 128 x 256 or
// 256 x 128. So the tile is as large as the accumulators allow: BN = Cout
// up to 256 (ops/modulated_conv.py tile_n), BM = 256 where BN <= 128 and
// the grid stays two waves deep (tile_m).
//
// Design:
// * A ring of STAGES stages in dynamic shared memory (4 to 6, as many as
//   fit in 227 KB), each BM rows of A and BN rows of B, 64 channels of one
//   tap a row: 128 bytes, TMA's 128-byte swizzle, the K-major layout wgmma
//   reads (descriptor: SBO 1024 B, one 8-row swizzle atom; a k16 step
//   advances the start address by 32 B). Channels past Cin, rows past
//   Cout and pixels outside the tensor arrive as TMA's zero fill: the conv's
//   padding never exists in memory, and any Cin % 8 == 0 runs on 64-channel
//   stages (a Cin of 16 to 48 pays for a stage of zeros).
// * B comes by a tiled 3-D TMA box (64 channels x BN rows x 1 tap) of the
//   weights. A comes by a tiled 4-D box of x * s (64 channels x tw x th x
//   nb pixels) placed at the tap's shifted coordinates (non-up body), or by
//   TMA's im2col mode walking BM consecutive positions of the body's grid,
//   the tap as the im2col offsets (up body): the kernels say why.
// * Warp roles, one if/else that never reconverges: warps 0-7 are two
//   consumer warpgroups, each the wgmma of BM / 2 rows of the tile (one or
//   two m64 blocks); warps 8-11 the producer warpgroup, one thread of which
//   walks (tap, 64-channel chunk): wait for the stage's empty barrier, arm
//   its full barrier with the stage's bytes, issue the two loads. A
//   consumer warpgroup waits on the full barrier, issues 4 (or 8) wgmmas,
//   commits, waits until one group is in flight and then releases the
//   previous stage (one arrival per warpgroup on its empty barrier, count
//   2). 384 threads have 168 registers each; with tiles of 128
//   accumulators a thread the producer warpgroup drops to 40 and the
//   consumers rise to 232 (setmaxnreg). A producer of one warp (288
//   threads) deadlocked there on the card: the consumers' setmaxnreg.inc
//   waited for registers that never came free.
// * Epilogue: once both warpgroups are done the ring is free; the raw sums
//   go there (BM rows of BN + 8 floats), then each thread takes a row's 8
//   (bf16 out) or 4 (float32 out) adjacent channels, applies the body's
//   fp32 epilogue with 16-byte loads of demod and bias, and stores them in
//   one 16-byte store. A row table (the destination, the image, the noise
//   term), filled while the first stages load, maps tile rows to outputs.
//   A tile's fill and stores take about as long as the MMAs of a
//   short-K tile (18 stages at 256^2 x 128), yet three variants that
//   attacked them ran slower or no faster on the card while this was
//   designed (all are gone): staging the finished values (the epilogue per
//   column pair, with 8-byte loads of demod and bias); one persistent block
//   an SM walking all tiles and storing straight from the registers, so
//   that the ring could take the next tile's loads during the epilogue;
//   and the same persistent walk with the finished tile in shared memory
//   of its own, leaving by TMA stores while the next tile ran (its ring
//   one stage shorter).
//
// Requires Cin % 8 == 0 and Cout % 8 == 0 (16-byte TMA strides and
// vectors) and 16-byte-aligned tensors (the wrappers check).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16wg {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // channels a stage: one 128-byte swizzled row
constexpr int CONSUMERS = 256;
constexpr int NT = CONSUMERS + 128;  // + the producer warpgroup
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int ALIGN = 1024;         // the 128-byte swizzle's atom: 8 rows
constexpr int MAX_STAGES = 6;
// A tile row's output: where it starts in the destination (elements, -1:
// no output), its image and its noise term (non-up body).
struct RowInfo {
  int64_t off;
  int b;
  float nz;
};
constexpr int TABLE_BYTES = 256 * sizeof(RowInfo);  // the row table, 256 rows at most
// 384 threads get at most 168 registers each, too few for 128 accumulators
// and the epilogue: tiles with that many take the producer warpgroup down
// to 40 and the consumers up to 232 (setmaxnreg), which frees exactly what
// they take; their shared memory keeps them one block an SM, so no other
// block holds the registers they wait for.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// A BM x BN tile: BM = 128 (each consumer warpgroup one m64 block) or 256
// (two), BN output channels.
template <int BM, int BN>
struct Tile {
  static constexpr int MI = BM / 128;  // m64 blocks a consumer warpgroup
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT =
      (SMEM_LIMIT - ALIGN - 16 * MAX_STAGES - TABLE_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // alignment slack, the ring, full and empty barriers, the row table
  static constexpr int SMEM_BYTES = ALIGN + RING_BYTES + 16 * STAGES + TABLE_BYTES;
  static constexpr int PITCH = BN + 8;  // a staged row, elements
  static constexpr int ACC = BN / 2;    // fp32 accumulators an m64 block, a thread
  static constexpr bool REBALANCE = MI * ACC >= 128;
  static_assert(BM == 128 || BM == 256, "two consumer warpgroups of m64 blocks");
  static_assert(BM * PITCH * 4 <= RING_BYTES, "the fp32 staged tile fits the ring");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "the ring fits");
  static_assert(!REBALANCE || 2 * SMEM_BYTES > SMEM_LIMIT,
                "setmaxnreg needs one block an SM");
};

// The tile width for Cout output channels: the smallest of 16, 32, 64 and
// 128 that holds them, else 256 (ops/modulated_conv.py tile_n).
inline int tile_n(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// one arrival that also arms the phase for `bytes` of TMA writes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: a tiled box of a 3-D or 4-D tensor map into shared memory at dst,
// completed on bar; coordinates innermost first, out of range -> zeros
__device__ __forceinline__ void tma_tile_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_tile_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// TMA im2col: the map's pixels_per_column pixels from base pixel (w, h, n)
// on, walking w, then h, then n inside the map's bounding box, each read at
// (w + off_w, h + off_h): channels c .. c + 63 of each into one row
__device__ __forceinline__ void tma_im2col_4d(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int c, int w, int h,
                                              int n, uint16_t off_w,
                                              uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle, at a 1024-byte-aligned address: start >> 4, LBO 1 (unused),
// SBO 1024 B >> 4, layout 1 (SWIZZLE_128B) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int MI, int R>
__device__ __forceinline__ void fence_acc(float (&d)[MI][R]) {
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// d (64 x N, fp32) += A (64 x 16, bf16) * B (N x 16, bf16)^T, both from
// shared memory by descriptor, K-major (no transpose); scale_d 0 drops d
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 16) wgmma_n16(d, da, db, 1);
  else if constexpr (BN == 32) wgmma_n32(d, da, db, 1);
  else if constexpr (BN == 64) wgmma_n64(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, 1);
  else wgmma_n256(d, da, db, 1);
}

// Shared memory: the ring from the first 1024-byte boundary, then the full
// and the empty barriers, then the row table.
template <int BM, int BN>
struct Ring {
  using TL = Tile<BM, BN>;
  uint32_t base;        // shared address of stage 0
  unsigned char* gen;   // the same, as a generic pointer
  __device__ uint32_t a(int s) const { return base + s * TL::STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + TL::A_BYTES; }
  __device__ uint32_t full(int s) const { return base + TL::RING_BYTES + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + TL::RING_BYTES + 8 * (TL::STAGES + s);
  }
  __device__ RowInfo* table() const {
    return reinterpret_cast<RowInfo*>(gen + TL::RING_BYTES + 16 * TL::STAGES);
  }
  __device__ float* staged() const { return reinterpret_cast<float*>(gen); }
};

// Carve the ring and initialise its barriers (full: the producer's one
// arrival plus the bytes; empty: one arrival per consumer warpgroup). Every
// thread of the block calls it, before the roles split.
template <int BM, int BN>
__device__ __forceinline__ Ring<BM, BN> ring_setup(unsigned char* smem_raw) {
  Ring<BM, BN> r;
  const uint32_t raw = smem_addr(smem_raw);
  r.base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  r.gen = smem_raw + (r.base - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile<BM, BN>::STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: for each (tap, 64-channel chunk) in order, wait for
// the stage to be free, arm its full barrier with `bytes`, then
// load(a, b, bar, tap, c0) issues the stage's TMA loads.
template <int BM, int BN, class Load>
__device__ __forceinline__ void produce(const Ring<BM, BN>& r, int ntaps, int chunks,
                                        uint32_t bytes, Load&& load) {
  int s = 0;
  uint32_t phase = 0;
  for (int tap = 0; tap < ntaps; ++tap) {
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(r.empty(s), phase ^ 1);  // passes at once on the first round
      mbar_expect(r.full(s), bytes);
      load(r.a(s), r.b(s), r.full(s), tap, c * BK);
      if (++s == Tile<BM, BN>::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup (wg 0 or 1: rows BM / 2 wg .. BM / 2 (wg + 1) - 1
// of the tile, as MI m64 blocks): acc = the sum over the T stages the
// producer fills.
template <int BM, int BN>
__device__ __forceinline__ void consume(float (&acc)[BM / 128][BN / 2],
                                        const Ring<BM, BN>& r, int T, int wg) {
  constexpr int MI = BM / 128;
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
  int s = 0, prev = -1;
  uint32_t phase = 0;
  const bool signals = (threadIdx.x & 127) == 0;
  for (int t = 0; t < T; ++t) {
    mbar_wait(r.full(s), phase);
    const uint64_t da = sw128_desc(r.a(s) + wg * (BM / 2) * BK * 2);
    const uint64_t db = sw128_desc(r.b(s));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
#pragma unroll
      for (int m = 0; m < MI; ++m)  // the next m64 block: 64 rows of 128 B on
        wgmma<BN>(acc[m], da + m * (64 * BK * 2 >> 4) + 2 * k, db + 2 * k);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's group is done: release it
    if (prev >= 0 && signals) mbar_arrive(r.empty(prev));
    prev = s;
    if (++s == Tile<BM, BN>::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// the 256 consumer threads only (named barrier 1; the producer warp has
// left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Where acc[m][i] lands in the tile (wgmma's m64nN accumulator layout, the
// consumer warpgroup's rows first, then its m64 block): row
// acc_row<BM>(m, i), column acc_col(i); acc[m][i + 1] (i even) is the next
// column of the same row.
template <int BM>
__device__ __forceinline__ int acc_row(int m, int i) {
  const int t = threadIdx.x;
  return (t >> 7) * (BM / 2) + m * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// Stage the tile's raw sums: BM rows of BN + 8 floats in the (free) ring,
// the thread's pairs (acc[m][i], acc[m][i + 1]) at (acc_row, acc_col).
template <int BM, int BN>
__device__ __forceinline__ void stage_acc(float* st, const float (&acc)[BM / 128][BN / 2]) {
#pragma unroll
  for (int m = 0; m < BM / 128; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(st + acc_row<BM>(m, i) * Tile<BM, BN>::PITCH + acc_col(i)) =
          make_float2(acc[m][i], acc[m][i + 1]);
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  u.x = *reinterpret_cast<uint32_t*>(&h[0]);
  u.y = *reinterpret_cast<uint32_t*>(&h[1]);
  u.z = *reinterpret_cast<uint32_t*>(&h[2]);
  u.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The epilogue and the stores: for each row r of the staged tile with
// table[r].off >= 0 and each group of V = 16 / sizeof(OutT) columns c
// (n0 + c < cout), the V sums go through f(table[r], n0 + c, v) (the
// body's fp32 epilogue, in place) and leave as OutT in one 16-byte store
// to dst + off + n0 + c; consecutive threads take consecutive groups.
template <int BM, int BN, class OutT, class F>
__device__ __forceinline__ void store_out(const float* st, const RowInfo* table, OutT* dst,
                                          int n0, int cout, F&& f) {
  constexpr int V = 16 / sizeof(OutT);  // elements a 16-byte store
  constexpr int CPR = BN / V;           // stores a row
  for (int i = threadIdx.x; i < BM * CPR; i += CONSUMERS) {
    const int row = i / CPR, c = (i % CPR) * V;
    const RowInfo ri = table[row];
    if (ri.off < 0 || n0 + c >= cout) continue;
    float v[V];
    const float4* src =
        reinterpret_cast<const float4*>(st + row * Tile<BM, BN>::PITCH + c);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = src[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
    f(ri, n0 + c, v);
    store16(dst + ri.off + n0 + c, v);
  }
}

// TMA reads a tensor map from memory on its first use: fetch it early
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- host side -----------------------------------------------------------

// libcuda's tensor-map encoders, found through the runtime's entry-point
// query (the library links no libcuda): null where libcuda lacks them.
template <class Fn>
inline Fn cuda_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<Fn>(fn)
                                                              : nullptr;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
using EncodeIm2col = decltype(&cuTensorMapEncodeIm2col);

// The weights (3, 3, Cout, Cin) bf16 as (Cin, Cout, 9), innermost first:
// a box of 64 channels x BN output channels x 1 tap.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int cin, int cout, int bn) {
  static const EncodeTiled enc = cuda_entry<EncodeTiled>("cuTensorMapEncodeTiled");
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)cin * 2, (cuuint64_t)cout * cin * 2};
  const cuuint32_t box[3] = {BK, (cuuint32_t)bn, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides,
             box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// x (B, H, W, Cin) bf16 as (Cin, W, H, B): a tiled box of 64 channels x
// tw x th x nb pixels.
inline cudaError_t pixel_box_map(CUtensorMap* map, const void* x, int b, int h, int w,
                                 int cin, int tw, int th, int nb) {
  static const EncodeTiled enc = cuda_entry<EncodeTiled>("cuTensorMapEncodeTiled");
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                 (cuuint64_t)h * w * cin * 2};
  const cuuint32_t box[4] = {BK, (cuuint32_t)tw, (cuuint32_t)th, (cuuint32_t)nb};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// x (B, H, W, Cin) bf16 in im2col mode: base pixels (w, h) over the
// bounding box [lower, dim - 1 + upper] per axis (W first), `pixels`
// pixels of 64 channels a load.
inline cudaError_t im2col_map(CUtensorMap* map, const void* x, int b, int h, int w,
                              int cin, const int (&lower)[2], const int (&upper)[2],
                              int pixels) {
  static const EncodeIm2col enc = cuda_entry<EncodeIm2col>("cuTensorMapEncodeIm2col");
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                 (cuuint64_t)h * w * cin * 2};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             lower, upper, BK, pixels, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Raise the kernel's dynamic shared memory limit and prefer shared memory
// over L1; cheap and idempotent, so every launch calls it.
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace bf16wg
