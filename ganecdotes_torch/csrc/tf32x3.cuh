// The 3xTF32 implicit-GEMM main loop that both StyledConv kernels run
// (styled_conv.cu: 9 taps of a 3x3 'same' conv; styled_up_conv.cu: the
// 4, 2, 2 or 1 taps of a phase class of the stride-2 transposed conv).
//
// A block owns a BM x BN tile of out[m, n] = sum over (tap, c) of
// A_tap[m, c] * W_tap[n, c]: row m of A_tap is the input pixel that output
// pixel m reads through the tap (zero outside the image), W_tap is the
// tap's (Cout, Cin) weight slice, k contiguous.
//
// Arithmetic: tensor cores in 3xTF32, fp32 accuracy without fp32 SIMT
// rates. Each fp32 operand splits into a TF32 big part and a TF32 small
// part, a = a_hi + a_lo (each rounded to nearest, ties away, as
// cvt.rna.tf32.f32 does), and mma.sync.m16n8k8 accumulates a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi in fp32; the a_lo*b_lo term (2^-22 relative) is
// dropped. The tensor cores' own fp32 sums truncate, so the 12 MMAs of each
// 32-channel stage sum from 0 into a partial tile that joins the running
// sum with a rounded fp32 add (on an H100, one chain of 768 MMAs drifted
// by 1e-4 relative).
//
// Layout: 8 warps, each 64 x 32 of the tile (the running and partial sums
// take 128 registers, so one block per SM). K advances in chunks of 32
// channels of one tap through a 4-stage ring in dynamic shared memory,
// filled by cp.async with zero fill for pixels outside the image, rows past
// M, channels past Cin and columns past Cout; both tiles keep k contiguous
// with a row pitch of 36 floats, so ldmatrix reads them without bank
// conflicts. Requires Cin % 4 == 0, Cout % 4 == 0 and 16-byte-aligned
// pointers (the wrappers check).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PITCH = BK + 4;  // floats per smem row: conflict-free ldmatrix
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int STAGE_FLOATS = (BM + BN) * PITCH;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
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

// fp32 bits rounded to TF32 (10 mantissa bits), to nearest, ties away:
// add half of the 13 dropped bits, then clear them (what cvt.rna.tf32.f32
// does, in two integer operations instead of its four)
__device__ __forceinline__ uint32_t to_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// fp32 bits -> (big, small) TF32 parts, big + small = x to 2^-22
__device__ __forceinline__ void split(uint32_t bits, uint32_t& hi,
                                      uint32_t& lo) {
  hi = to_tf32(bits);
  lo = to_tf32(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

// d (+)= a * b; ZERO starts the sum at 0 instead of d
template <bool ZERO>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (ZERO) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// one 8-deep step of the 64 x 32 warp tile: the three products of each
// fragment pair, small ones first, into part (started at 0 when ZERO)
template <bool ZERO>
__device__ __forceinline__ void warp_step(float (&part)[4][4][4],
                                          const float* As, const float* Bs,
                                          int a_off, int b_off) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    uint32_t r[4];
    ldmatrix_x4(r, smem_addr(Bs + b_off + jj * 16 * PITCH));
    split(r[0], bh[2 * jj][0], bl[2 * jj][0]);
    split(r[1], bh[2 * jj][1], bl[2 * jj][1]);
    split(r[2], bh[2 * jj + 1][0], bl[2 * jj + 1][0]);
    split(r[3], bh[2 * jj + 1][1], bl[2 * jj + 1][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t r[4], ah[4], al[4];
    ldmatrix_x4(r, smem_addr(As + a_off + i * 16 * PITCH));
#pragma unroll
    for (int q = 0; q < 4; ++q) split(r[q], ah[q], al[q]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_tf32<ZERO>(part[i][j], al, bh[j][0], bh[j][1]);
      mma_tf32<false>(part[i][j], ah, bl[j][0], bl[j][1]);
      mma_tf32<false>(part[i][j], ah, bh[j][0], bh[j][1]);
    }
  }
}

// The A rows this thread loads: tile rows (tid >> 3) + 32 i. Output pixel
// m of a (B, Hg, Wg) grid reads input pixel (y, x) of image b plus the
// tap's offset; pix is that pixel's index in the (B, H, W) input.
struct ARows {
  int pix[4], y[4], x[4];
};

__device__ __forceinline__ ARows a_rows(int m0, int M, int Hg, int Wg, int H,
                                        int W) {
  ARows a;
  const int HWg = Hg * Wg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (threadIdx.x >> 3) + 32 * i;
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
// (y + dy, x + dx); rows n0 + [0, 128) of its weight slice w_tap (Cout, Cin).
__device__ __forceinline__ void load_stage(float* stage, const float* xm,
                                           const float* w_tap, const ARows& a,
                                           int dy, int dx, int c0, int n0,
                                           int H, int W, int Cin, int Cout) {
  const int tid = threadIdx.x;
  const int kc = (tid & 7) * 4;
  const int ci = c0 + kc;
  const bool ci_ok = ci < Cin;
  float* As = stage;
  float* Bs = As + BM * PITCH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (tid >> 3) + 32 * i;
    const int iy = a.y[i] + dy, ix = a.x[i] + dx;
    const bool ok = ci_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    const float* src =
        ok ? xm + (int64_t)(a.pix[i] + dy * W + dx) * Cin + ci : xm;
    cp_async16(smem_addr(As + row * PITCH + kc), src, ok);
    const int n = n0 + row;
    const bool okb = ci_ok && n < Cout;
    const float* srcb = okb ? w_tap + (int64_t)n * Cin + ci : w_tap;
    cp_async16(smem_addr(Bs + row * PITCH + kc), srcb, okb);
  }
}

// acc = the tile's sum over ntaps taps of Cin channels each.
// load_tap(stage, tap, c0) fills one ring slot (with load_stage); the walk
// over (tap, 32-channel chunk) is here, without divisions.
template <class LoadTap>
__device__ __forceinline__ void gemm(float (&acc)[4][4][4], float* smem,
                                     int ntaps, int Cin, LoadTap&& load_tap) {
  const int T = ntaps * ((Cin + BK - 1) / BK);
  int ld_tap = 0, ld_c0 = 0;
  auto load_next = [&](int slot) {
    load_tap(smem + slot * STAGE_FLOATS, ld_tap, ld_c0);
    if ((ld_c0 += BK) >= Cin) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (wm * 64 + lr + (lm & 1) * 8) * PITCH + (lm >> 1) * 4;
  const int b_off = (wn * 32 + lr + (lm >> 1) * 8) * PITCH + (lm & 1) * 4;

  float part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
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

    const float* As = smem + (t % STAGES) * STAGE_FLOATS;
    const float* Bs = As + BM * PITCH;
    warp_step<true>(part, As, Bs, a_off, b_off);
#pragma unroll
    for (int kk = 8; kk < BK; kk += 8)
      warp_step<false>(part, As + kk, Bs + kk, a_off, b_off);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Where acc[i][j][2 h + e] lands in the tile: row frag_row(i, h), column
// frag_col(j) + e (the m16n8 accumulator layout).
__device__ __forceinline__ int frag_row(int i, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 64 + i * 16 + h * 8 + (lane >> 2);
}

__device__ __forceinline__ int frag_col(int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 3) * 32 + j * 8 + (lane & 3) * 2;
}

// Raise the kernel's dynamic shared memory limit above 48 KB and prefer
// shared memory over L1; cheap and idempotent, so every launch calls it.
template <class Kernel>
inline cudaError_t set_smem(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace tf32x3
