// The bfloat16 implicit-GEMM main loop that both StyledConv kernels run on
// bf16 activations (styled_conv.cu: 9 taps of a 3x3 'same' conv;
// styled_up_conv.cu: the 4, 2, 2 or 1 taps of a phase class of the
// stride-2 transposed conv). The float32 kernels run tf32x3.cuh instead.
//
// A block owns a BM x BN tile of out[m, n] = sum over (tap, c) of
// A_tap[m, c] * W_tap[n, c]: row m of A_tap is the input pixel that output
// pixel m reads through the tap (zero outside the image), W_tap is the
// tap's (Cout, Cin) weight slice, k contiguous.
//
// Arithmetic: mma.sync.m16n8k16 with bf16 A and B and fp32 accumulators,
// one pass (the bf16 operands are what the JAX kernel feeds its MXU,
// ganecdotes_tpu/ops/modulated_conv_pallas.py:166-184, with
// preferred_element_type float32). The epilogue stays in fp32 and the
// kernels round once, on the store.
//
// Tiling by Cout: BN is 16, 32, 64 or 128 (the wrapper picks the smallest
// that holds Cout, 128 above it), so BagGAN's lean widths (Cout 16-64) do
// not pay for a 128-wide tile of zeros. 8 warps share the tile as WM x WN
// warps of (BM / WM) x (BN / WN). K advances in chunks of 32 channels of
// one tap through a 4-stage ring in dynamic shared memory, filled by 16-byte
// cp.async copies (8 channels; zero fill for pixels outside the image, rows
// past M, chunks past Cin and columns past Cout), both tiles k contiguous
// with a row pitch of 40 bf16 (80 bytes), so ldmatrix reads them without
// bank conflicts. Requires Cin % 8 == 0, Cout % 8 == 0 and 16-byte-aligned
// pointers (the wrappers check).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BK = 32;          // channels per stage
constexpr int PITCH = BK + 8;   // bf16 per smem row: conflict-free ldmatrix
constexpr int STAGES = 4;
constexpr int NT = 256;

template <int BN>
struct Tile {
  static constexpr int WN = BN >= 128 ? 4 : (BN >= 32 ? 2 : 1);
  static constexpr int WM = 8 / WN;
  static constexpr int WTM = BM / WM;  // a warp's rows
  static constexpr int WTN = BN / WN;  // a warp's columns
  static constexpr int MI = WTM / 16;  // m16 fragments a warp
  static constexpr int NJ = WTN / 8;   // n8 fragments a warp (even)
  static constexpr int STAGE_ELEMS = (BM + BN) * PITCH;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A rows this thread loads: tile rows (tid >> 2) + 64 i, channels
// (tid & 3) * 8 of each stage. Output pixel m of a (B, Hg, Wg) grid reads
// input pixel (y, x) of image b plus the tap's offset; pix is that pixel's
// index in the (B, H, W) input.
struct ARows {
  int pix[2], y[2], x[2];
};

__device__ __forceinline__ ARows a_rows(int m0, int M, int Hg, int Wg, int H,
                                        int W) {
  ARows a;
  const int HWg = Hg * Wg;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (threadIdx.x >> 2) + 64 * i;
    if (m < M) {
      const int b = m / HWg;
      const int r = m - b * HWg;
      a.y[i] = r / Wg;
      a.x[i] = r - a.y[i] * Wg;
      a.pix[i] = (b * H + a.y[i]) * W + a.x[i];
    } else {
      a.y[i] = -8;  // every tap (offsets -2 .. 1) falls outside: zero fill
      a.x[i] = 0;
      a.pix[i] = 0;
    }
  }
  return a;
}

// One stage: channels c0 + [0, 32) of the tap that reads input pixel
// (y + dy, x + dx); rows n0 + [0, BN) of its weight slice w_tap (Cout, Cin).
template <int BN>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* xm,
                                           const bf16* w_tap, const ARows& a,
                                           int dy, int dx, int c0, int n0,
                                           int H, int W, int Cin, int Cout) {
  const int tid = threadIdx.x;
  const int kc = (tid & 3) * 8;
  const int ci = c0 + kc;
  const bool ci_ok = ci < Cin;
  bf16* As = stage;
  bf16* Bs = As + BM * PITCH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + 64 * i;
    const int iy = a.y[i] + dy, ix = a.x[i] + dx;
    const bool ok = ci_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    const bf16* src =
        ok ? xm + (int64_t)(a.pix[i] + dy * W + dx) * Cin + ci : xm;
    cp_async16(smem_addr(As + row * PITCH + kc), src, ok);
  }
#pragma unroll
  for (int idx = tid; idx < BN * 4; idx += NT) {
    const int row = idx >> 2;  // idx & 3 == tid & 3: the same channels
    const int n = n0 + row;
    const bool okb = ci_ok && n < Cout;
    const bf16* srcb = okb ? w_tap + (int64_t)n * Cin + ci : w_tap;
    cp_async16(smem_addr(Bs + row * PITCH + kc), srcb, okb);
  }
}

// acc = the tile's sum over ntaps taps of Cin channels each.
// load_tap(stage, tap, c0) fills one ring slot (with load_stage); the walk
// over (tap, 32-channel chunk) is here, without divisions.
template <int BN, class LoadTap>
__device__ __forceinline__ void gemm(
    float (&acc)[Tile<BN>::MI][Tile<BN>::NJ][4], bf16* smem, int ntaps,
    int Cin, LoadTap&& load_tap) {
  using TL = Tile<BN>;
  const int T = ntaps * ((Cin + BK - 1) / BK);
  int ld_tap = 0, ld_c0 = 0;
  auto load_next = [&](int slot) {
    load_tap(smem + slot * TL::STAGE_ELEMS, ld_tap, ld_c0);
    if ((ld_c0 += BK) >= Cin) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  // ldmatrix row addresses. A (x4): lanes 0-15 rows 0-15 at k 0, lanes
  // 16-31 the same rows at k 8 -> a0..a3 of m16n8k16. B (x4, two n8
  // fragments): lanes 0-7 n 0-7 at k 0, 8-15 n 0-7 at k 8, 16-23 n 8-15 at
  // k 0, 24-31 n 8-15 at k 8 -> (b0, b1) of fragment j, then of j + 1.
  const int a_off = (wm * TL::WTM + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const int b_off =
      (wn * TL::WTN + (lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int i = 0; i < TL::MI; ++i)
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) load_next(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int t = 0; t < T; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // stage t landed; everyone is done with stage t - 1
    if (t + STAGES - 1 < T) load_next((t + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n" ::);

    const bf16* As = smem + (t % STAGES) * TL::STAGE_ELEMS;
    const bf16* Bs = As + BM * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[TL::NJ][2];
#pragma unroll
      for (int jj = 0; jj < TL::NJ / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(Bs + b_off + jj * 16 * PITCH + kk));
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < TL::MI; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(As + a_off + i * 16 * PITCH + kk));
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Where acc[i][j][2 h + e] lands in the tile: row frag_row(i, h), column
// frag_col(j) + e (the m16n8 accumulator layout).
template <int BN>
__device__ __forceinline__ int frag_row(int i, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / Tile<BN>::WN) * Tile<BN>::WTM + i * 16 + h * 8 + (lane >> 2);
}

template <int BN>
__device__ __forceinline__ int frag_col(int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % Tile<BN>::WN) * Tile<BN>::WTN + j * 8 + (lane & 3) * 2;
}

// Raise the kernel's dynamic shared memory limit above 48 KB and prefer
// shared memory over L1; cheap and idempotent, so every launch calls it.
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// The tile width for Cout output channels: the smallest of 16, 32 and 64
// that holds them, else 128.
inline int tile_n(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
}

}  // namespace bf16mma
