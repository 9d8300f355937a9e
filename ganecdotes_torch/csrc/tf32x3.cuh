// The 3xTF32 implicit-GEMM main loop that both float32 StyledConv kernels
// run (styled_conv.cu: the 9 taps of a 3x3 'same' conv; styled_up_conv.cu:
// the 4, 2, 2 or 1 taps of a phase class of the stride-2 transposed conv),
// on what Hopper added: TMA, mbarriers, a producer warpgroup and two
// consumer warpgroups running wgmma in its tf32 form. The mbarrier, TMA,
// descriptor, setmaxnreg and epilogue helpers are bf16_wgmma.cuh's.
//
// A block owns a BM x BN tile of out[m, n] = sum over (tap, c) of
// A_tap[m, c] * W_tap[n, c]: row m of A_tap is the input pixel that output
// pixel m reads through the tap (zero outside the image), W_tap the tap's
// (Cout, Cin) slice of the weights, k contiguous.
//
// Arithmetic: tensor cores in 3xTF32, fp32 accuracy without fp32 SIMT
// rates. Each fp32 operand splits into a TF32 big part and a TF32 small
// part, a = a_hi + a_lo (each rounded to nearest, ties away, as
// cvt.rna.tf32.f32 does), and wgmma accumulates a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi in fp32; the a_lo*b_lo term (2^-22 relative) is dropped. The
// tensor cores' own fp32 sums truncate, so the 12 wgmmas of each 32-channel
// stage sum from 0 into a partial tile that joins the running sum with a
// rounded fp32 add (on an H100, one chain of 768 MMAs drifted by 1e-4
// relative).
//
// Bound: operations, three tensor-core products per multiply-add at the
// TF32 rate (495 TFLOP/s dense), 2 * 9 * Cin * Cout flops a pixel. The
// mma.sync loop this replaced ran at 27-32% of that: mma.sync cannot reach
// the tensor cores' full rate on Hopper, and each of its warps re-split both
// operands from shared memory on every 8-deep step. What bounds this loop
// instead is what a stage feeds the tensor cores: a 32-channel stage of a
// 128 x 128 tile is 48 KB from L2 (A once, B's two planes) for 3.1 MFLOP,
// 64 flops a byte, about 32 bytes a clock and SM at the full rate, near
// what L2 delivers; and each warpgroup's partial sum must land before the
// next stage starts it from 0, which the other warpgroup's wgmmas cover.
//
// Design:
// * B is split once per call: tf32_split_weight_kernel turns the (3, 3,
//   Cin, Cout) weights into the (2, 9, Cout, Cin) TF32 planes hi and lo
//   (the transpose the wrapper used to make with torch), and TMA loads both
//   planes of a stage as tiled boxes of 32 channels x BN rows, which wgmma
//   reads from shared memory (tf32 wgmma takes both operands K-major, as
//   both already are).
// * A, the x * s pixels, comes by TMA's im2col mode, BM consecutive
//   positions of the body's grid flat across rows and images a load, the
//   tap as the im2col offsets: padding, ragged M and the positions past the
//   last image are TMA's zero fill, as channels past Cin are in both
//   operands. A consumer warpgroup ldmatrix-loads its 64 rows of the stage,
//   splits them into hi and lo in registers and feeds wgmma's register-A
//   form: A's small part never exists in memory.
// * A ring of STAGES stages in dynamic shared memory (4 at BN = 128, 6 at
//   BN <= 64), each BM rows of A and BN rows of each B plane, 32 fp32
//   channels a row: 128 bytes, TMA's 128-byte swizzle, the K-major layout
//   wgmma reads (descriptor: SBO 1024 B; a k8 step advances the start
//   address by 32 B), conflict-free for ldmatrix.
// * Warp roles as in bf16_wgmma.cuh: warps 0-7 two consumer warpgroups, each
//   the wgmmas of 64 rows of the tile; warps 8-11 the producer warpgroup,
//   one thread of which walks (tap, 32-channel chunk), waits for the stage's
//   empty barrier, arms its full barrier and issues the three loads. Per
//   stage a consumer warpgroup waits on the full barrier, loads and splits
//   its A fragments, issues 12 wgmmas into the partial tile (the first from
//   0), waits for them, releases the stage and adds the partial into its
//   running sum. The running and partial sums take BN accumulators a thread
//   (128 at BN = 128): the producer drops to 40 registers and the consumers
//   rise to 232 (setmaxnreg), one block an SM.
// * Epilogue: bf16_wgmma.cuh's, the raw sums staged in the free ring, then
//   each thread takes 4 adjacent channels of a row through the body's
//   epilogue and one 16-byte store.
//
// Requires Cin % 4 == 0 and Cout % 4 == 0 (16-byte TMA strides and
// vectors) and 16-byte-aligned tensors (the wrappers check).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"

namespace tf32x3 {

namespace hw = bf16wg;

constexpr int BM = 128;  // two consumer warpgroups of one m64 block each
constexpr int BK = 32;   // channels a stage: one 128-byte swizzled row
constexpr int NT = hw::NT;
constexpr int CONSUMERS = hw::CONSUMERS;
constexpr int MAX_STAGES = 6;

// A BM x BN tile, BN = 32, 64 or 128 output channels.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;  // one plane
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int FIT = (hw::SMEM_LIMIT - hw::ALIGN - 16 * MAX_STAGES - hw::TABLE_BYTES) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // alignment slack, the ring, full and empty barriers, the row table
  static constexpr int SMEM_BYTES = hw::ALIGN + RING_BYTES + 16 * STAGES + hw::TABLE_BYTES;
  static constexpr int ACC = BN / 2;  // fp32 accumulators a thread, each of the two sums
  static constexpr bool REBALANCE = BN >= 128;
  static_assert(BN == 32 || BN == 64 || BN == 128, "tf32 tile widths");
  static_assert(BM * (BN + 8) * 4 <= RING_BYTES, "the fp32 staged tile fits the ring");
  static_assert(SMEM_BYTES <= hw::SMEM_LIMIT, "the ring fits");
  static_assert(!REBALANCE || 2 * SMEM_BYTES > hw::SMEM_LIMIT,
                "setmaxnreg needs one block an SM");
};

// The tile width for Cout output channels: the smallest of 32 and 64 that
// holds them, else 128 (ops/modulated_conv.py tf32_tile_n).
inline int tile_n(int cout) { return cout <= 32 ? 32 : cout <= 64 ? 64 : 128; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// fp32 bits rounded to TF32 (10 mantissa bits), to nearest, ties away:
// add half of the 13 dropped bits, then clear them (what cvt.rna.tf32.f32
// does, in two integer operations instead of its four)
__device__ __forceinline__ uint32_t to_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// fp32 bits -> (big, small) TF32 parts, big + small = x to 2^-22
__device__ __forceinline__ void split(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(bits);
  lo = to_tf32(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

// keep the compiler from reusing or moving A's registers across the
// asynchronous wgmmas that read them
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[k][q])::"memory");
}

// d (64 x N, fp32) (+)= A (64 x 8, tf32, registers: wgmma's m64k8 fragment)
// * B (N x 8, tf32, shared memory by descriptor, K-major); scale_d 0 drops d
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (BN == 32) wgmma_n32(d, a, db, scale_d);
  else if constexpr (BN == 64) wgmma_n64(d, a, db, scale_d);
  else wgmma_n128(d, a, db, scale_d);
}

// Shared memory: the ring from the first 1024-byte boundary (each stage A,
// then B's hi plane, then its lo plane), then the full and the empty
// barriers, then the row table.
template <int BN>
struct Ring {
  using TL = Tile<BN>;
  uint32_t base;       // shared address of stage 0
  unsigned char* gen;  // the same, as a generic pointer
  __device__ uint32_t a(int s) const { return base + s * TL::STAGE_BYTES; }
  __device__ uint32_t bhi(int s) const { return a(s) + TL::A_BYTES; }
  __device__ uint32_t blo(int s) const { return bhi(s) + TL::B_BYTES; }
  __device__ uint32_t full(int s) const { return base + TL::RING_BYTES + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + TL::RING_BYTES + 8 * (TL::STAGES + s);
  }
  __device__ hw::RowInfo* table() const {
    return reinterpret_cast<hw::RowInfo*>(gen + TL::RING_BYTES + 16 * TL::STAGES);
  }
  __device__ float* staged() const { return reinterpret_cast<float*>(gen); }
};

// Carve the ring and initialise its barriers (full: the producer's one
// arrival plus the bytes; empty: one arrival per consumer warpgroup). Every
// thread of the block calls it, before the roles split.
template <int BN>
__device__ __forceinline__ Ring<BN> ring_setup(unsigned char* smem_raw) {
  Ring<BN> r;
  const uint32_t raw = hw::smem_addr(smem_raw);
  r.base = (raw + hw::ALIGN - 1) & ~static_cast<uint32_t>(hw::ALIGN - 1);
  r.gen = smem_raw + (r.base - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile<BN>::STAGES; ++s) {
      hw::mbar_init(r.full(s), 1);
      hw::mbar_init(r.empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: for each (tap, 32-channel chunk) in order, wait for
// the stage to be free, arm its full barrier with the stage's bytes, then
// load(a, bhi, blo, bar, tap, c0) issues its three TMA loads.
template <int BN, class Load>
__device__ __forceinline__ void produce(const Ring<BN>& r, int ntaps, int chunks, Load&& load) {
  int s = 0;
  uint32_t phase = 0;
  for (int tap = 0; tap < ntaps; ++tap) {
    for (int c = 0; c < chunks; ++c) {
      hw::mbar_wait(r.empty(s), phase ^ 1);  // passes at once on the first round
      hw::mbar_expect(r.full(s), Tile<BN>::STAGE_BYTES);
      load(r.a(s), r.bhi(s), r.blo(s), r.full(s), tap, c * BK);
      if (++s == Tile<BN>::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup (wg 0 or 1: rows 64 wg .. 64 wg + 63 of the tile):
// acc = the sum over the T stages the producer fills, each stage's 12
// wgmmas (per 8-deep step a_lo * b_hi, a_hi * b_lo, a_hi * b_hi) summed
// from 0 into part, which then joins acc with a rounded fp32 add.
template <int BN>
__device__ __forceinline__ void consume(float (&acc)[1][BN / 2], const Ring<BN>& r, int T,
                                        int wg) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[0][i] = 0.f;
  float part[1][BN / 2];
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8, which
  // covers rows (l / 8 & 1) * 8 .. + 7 of the warp's 16 and the 16-byte
  // chunk l / 16 of the 8-deep step; each thread then holds the m64k8
  // fragment (rows g, g + 8; columns t, t + 4). The 128-byte swizzle puts
  // 16-byte chunk j of row q at chunk j ^ (q % 8).
  const int lane = threadIdx.x & 31;
  const int row = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t row_off = row * (BK * 4);
  const int sw = row & 7, half = lane >> 4;
  int s = 0;
  uint32_t phase = 0;
  const bool signals = (threadIdx.x & 127) == 0;
  for (int t = 0; t < T; ++t) {
    hw::mbar_wait(r.full(s), phase);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      uint32_t v[4];
      ldmatrix_x4(v, r.a(s) + row_off + (((2 * k + half) ^ sw) << 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], ah[k][q], al[k][q]);
    }
    const uint64_t dh = hw::sw128_desc(r.bhi(s));
    const uint64_t dl = hw::sw128_desc(r.blo(s));
    fence_a(ah);
    fence_a(al);
    hw::fence_acc(part);
    hw::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {  // small products first; k 0 starts part at 0
      wgmma<BN>(part[0], al[k], dh + 2 * k, k);
      wgmma<BN>(part[0], ah[k], dl + 2 * k, 1);
      wgmma<BN>(part[0], ah[k], dh + 2 * k, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_acc(part);
    fence_a(ah);
    fence_a(al);
    if (signals) hw::mbar_arrive(r.empty(s));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[0][i] += part[0][i];
    if (++s == Tile<BN>::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
}

// The weights (3, 3, Cin, Cout) -> their TF32 planes (2, 9, Cout, Cin): hi
// then lo, k contiguous per output channel. A 32 x 32 block of one tap a
// block of 32 x 8 threads, through shared memory, so both sides move whole
// rows. (static: each source that includes this header has its own.)
static __global__ void tf32_split_weight_kernel(const float* __restrict__ w, float* __restrict__ planes,
                                         int cin, int cout) {
  __shared__ float blk[32][33];
  const int tap = blockIdx.z;
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 32;
  const float* src = w + (int64_t)tap * cin * cout;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + threadIdx.x;
    if (ci < cin && co < cout) blk[r][threadIdx.x] = src[(int64_t)ci * cout + co];
  }
  __syncthreads();
  float* hi = planes + (int64_t)tap * cout * cin;
  float* lo = hi + (int64_t)9 * cout * cin;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + threadIdx.x;
    if (ci < cin && co < cout) {
      uint32_t h, l;
      split(__float_as_uint(blk[threadIdx.x][r]), h, l);
      hi[(int64_t)co * cin + ci] = __uint_as_float(h);
      lo[(int64_t)co * cin + ci] = __uint_as_float(l);
    }
  }
}

// ---- host side -----------------------------------------------------------

inline cudaError_t split_weights(const float* w, float* planes, int cin, int cout,
                                 cudaStream_t s) {
  const dim3 grid((cout + 31) / 32, (cin + 31) / 32, 9);
  tf32_split_weight_kernel<<<grid, dim3(32, 8), 0, s>>>(w, planes, cin, cout);
  return cudaGetLastError();
}

// The planes (2, 9, Cout, Cin) float32 as (Cin, Cout, 18), innermost
// first: a box of 32 channels x BN output channels x 1 (plane, tap).
inline cudaError_t weight_map(CUtensorMap* map, const float* planes, int cin, int cout,
                              int bn) {
  static const hw::EncodeTiled enc = hw::cuda_entry<hw::EncodeTiled>("cuTensorMapEncodeTiled");
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 18};
  const cuuint64_t strides[2] = {(cuuint64_t)cin * 4, (cuuint64_t)cout * cin * 4};
  const cuuint32_t box[3] = {BK, (cuuint32_t)bn, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(planes), dims, strides,
             box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// x (B, H, W, Cin) float32 in im2col mode: base pixels (w, h) over the
// bounding box [lower, dim - 1 + upper] per axis (W first), BM pixels of
// 32 channels a load.
inline cudaError_t im2col_map(CUtensorMap* map, const float* x, int b, int h, int w, int cin,
                              const int (&lower)[2], const int (&upper)[2]) {
  static const hw::EncodeIm2col enc =
      hw::cuda_entry<hw::EncodeIm2col>("cuTensorMapEncodeIm2col");
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)w * cin * 4,
                                 (cuuint64_t)h * w * cin * 4};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims, strides,
             lower, upper, BK, BM, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace tf32x3
