// StyleGAN2's upsampling StyledConv body, on the (2H, 2W) grid:
//
//   out = lrelu(blur(demod * convT_s2(x * s, W)) + nw * noise + bias, 0.2) * sqrt(2)
//
// Replaces ganecdotes_tpu/ops/modulated_conv_pallas.py::styled_up_conv3x3
// (_up_pallas_forward, the pallas_call at :466). The TPU kernel composes the
// [1,3,3,1] blur into the transposed conv, giving four dense 3x3 phase
// filters: 36 * Cin * Cout MACs per input pixel. Here the two stay apart and
// each does only the work that sees data, 9 * Cin * Cout MACs per input
// pixel, a quarter:
//
// 1. up_gemm_kernel: T = demod * convT_s2(xm, W), the stride-2 3x3
//    transposed conv with padding 0 (ops/modulated_conv.py
//    styled_up_conv3x3_xla), (B, 2H+1, 2W+1, Cout), into a scratch tensor
//    the wrapper allocates. Per axis, T row Y = 2m + p reads
//        p = 0: x row m with kernel row 0, x row m - 1 with kernel row 2
//               (m in [0, H], H + 1 rows);
//        p = 1: x row m with kernel row 1 (m in [0, H - 1], H rows),
//    so the four output phase classes (py, px) have 4, 2, 2 and 1 taps and
//    K = 4, 2, 2, 1 times Cin. Each class is an implicit GEMM with
//    M = B * rows * cols of the class, N = Cout, K = taps * Cin; demod (per
//    output channel, which commutes with the depthwise blur) is applied in
//    its epilogue.
// 2. up_blur_epilogue_kernel: the 4x4 blur of T (true convolution, pad 1
//    per side, gain 4: the wrapper passes the separable 1-D taps
//    2 * k / sum(k)), then noise, bias, leaky-ReLU and sqrt(2), written once.
//
// Bound: operations. 2 * 9 * Cin * Cout flops per input pixel against a few
// bytes per output; at the ffhq-256 widths (102.9 G MACs per request of 8)
// the convT is far above the tensor cores' balance point.
// Design of the GEMM: tensor cores in 3xTF32, fp32 accuracy without fp32
// SIMT rates. Each fp32 operand splits into a TF32 big part and a TF32
// small part, a = a_hi + a_lo (each rounded to nearest, ties away, as
// cvt.rna.tf32.f32 does), and mma.sync.m16n8k8 accumulates a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi in fp32; the a_lo*b_lo term (2^-22 relative) is
// dropped. Plain TF32 would keep about 3 digits over K = 2048 and is not
// offered. The tensor cores' own fp32 sums truncate, so the 12 MMAs of each
// 32-channel stage sum from 0 into a partial tile that joins the running
// sum with a rounded fp32 add (on an H100, one chain of 768 MMAs drifted
// by 1e-4 relative).
// A block owns a 128 x 128 output tile of one phase class (8 warps, each
// 64 x 32; the running and partial sums take 128 registers, so one block
// per SM) and walks K in chunks of 32 channels of one tap. A (the gathered
// x * s pixels of that tap, zero outside the image) and B (the tap's weight
// slice, stored n-major: the wrapper passes w as (3, 3, Cout, Cin)) go
// through a 4-stage ring in dynamic shared memory, filled by cp.async with
// zero fill for pixels outside the image, rows past M, channels past Cin
// and columns past Cout; both tiles keep k contiguous with a row pitch of
// 36 floats, so ldmatrix reads them without bank conflicts. One flat grid
// covers the four classes with the 4-tap tiles first and the 1-tap tiles
// last, so the short tiles fill the SMs the long ones leave idle at the end.
// Requires Cin % 4 == 0, Cout % 4 == 0 and 16-byte-aligned pointers (the
// wrapper checks).
//
// The blur kernel is bound by bytes (16 taps per output, reading T once
// from device memory at best): one thread owns a 2 x 2 block of outputs and
// 4 channels, reads the 5 x 5 window of T it needs once, blurs it
// separably and writes the 16 outputs as four 16-byte vectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PITCH = BK + 4;  // floats per smem row: conflict-free ldmatrix
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int STAGE_FLOATS = (BM + BN) * PITCH;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr float SQRT2 = 1.4142135623730951f;

struct PhaseTiles {
  int first[5];  // first block of each phase class, first[4] = grid size
  int tiles_n;
};

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

__global__ void __launch_bounds__(NT, 1)
up_gemm_kernel(const float* __restrict__ xm,     // (B, H, W, Cin)
               const float* __restrict__ w,      // (3, 3, Cout, Cin)
               const float* __restrict__ demod,  // (B, Cout)
               float* __restrict__ t_out,        // (B, 2H+1, 2W+1, Cout)
               PhaseTiles pt, int B, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  int phase = 0;
  while (phase < 3 && (int)blockIdx.x >= pt.first[phase + 1]) ++phase;
  const int local = blockIdx.x - pt.first[phase];
  const int m0 = (local / pt.tiles_n) * BM;
  const int n0 = (local % pt.tiles_n) * BN;
  const int py = phase >> 1, px = phase & 1;
  const int Hp = H + 1 - py, Wp = W + 1 - px;  // rows, cols of this class
  const int HWp = Hp * Wp;
  const int M = B * HWp;
  const int ntx = 2 - px;  // x taps: 2 for px = 0, 1 for px = 1
  const int ntaps = (2 - py) * ntx;
  const int kchunks = (Cin + BK - 1) / BK;
  const int T = ntaps * kchunks;

  // loaders: rows (tid >> 3) + 32 i of the A and B tiles, 4 floats at kc
  const int kc = (tid & 7) * 4;
  int a_pix[4], a_y[4], a_x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 3) + 32 * i;
    if (m < M) {
      const int b = m / HWp;
      const int r = m - b * HWp;
      a_y[i] = r / Wp;
      a_x[i] = r - a_y[i] * Wp;
      a_pix[i] = (b * H + a_y[i]) * W + a_x[i];
    } else {
      a_y[i] = -4;  // every tap falls outside the image: zero fill
      a_x[i] = 0;
      a_pix[i] = 0;
    }
  }

  // the next stage to load walks (tap, channel chunk) without divisions
  int ld_tap = 0, ld_ci = kc;
  auto load_stage = [&](int slot) {
    const int tap = ld_tap, ci = ld_ci;
    if ((ld_ci += BK) >= kchunks * BK) {
      ld_ci = kc;
      ++ld_tap;
    }
    const int ty = ntx == 2 ? tap >> 1 : tap, tx = ntx == 2 ? tap & 1 : 0;
    const int ky = py ? 1 : 2 * ty, kx = px ? 1 : 2 * tx;
    const bool ci_ok = ci < Cin;
    float* As = smem + slot * STAGE_FLOATS;
    float* Bs = As + BM * PITCH;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 3) + 32 * i;
      const int iy = a_y[i] - ty, ix = a_x[i] - tx;
      const bool ok = ci_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src =
          ok ? xm + (int64_t)(a_pix[i] - ty * W - tx) * Cin + ci : xm;
      cp_async16(smem_addr(As + row * PITCH + kc), src, ok);
      const int n = n0 + row;
      const bool okb = ci_ok && n < Cout;
      const float* srcb =
          okb ? w + ((int64_t)(ky * 3 + kx) * Cout + n) * Cin + ci : w;
      cp_async16(smem_addr(Bs + row * PITCH + kc), srcb, okb);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (wm * 64 + lr + (lm & 1) * 8) * PITCH + (lm >> 1) * 4;
  const int b_off = (wn * 32 + lr + (lm >> 1) * 8) * PITCH + (lm & 1) * 4;

  // The tensor cores' fp32 sums truncate, so a long chain of MMAs into one
  // sum drifts toward zero (1e-4 relative over K = 2048). Each stage sums
  // its 12 MMAs into part, from 0, and part joins acc with a rounded add.
  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) load_stage(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int t = 0; t < T; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // stage t landed; everyone is done with stage t - 1
    if (t + STAGES - 1 < T) load_stage((t + STAGES - 1) % STAGES);
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

  // epilogue: demod, then T[b, 2y + py, 2x + px, n] as float2 pairs
  const int TH = 2 * H + 1, TW = 2 * W + 1;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + h * 8 + g;
      if (m >= M) continue;
      const int b = m / HWp;
      const int r = m - b * HWp;
      const int y = r / Wp;
      const int x = r - y * Wp;
      float* trow =
          t_out + (((int64_t)b * TH + 2 * y + py) * TW + 2 * x + px) * Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + q2;
        if (n >= Cout) continue;
        const float2 d =
            *reinterpret_cast<const float2*>(demod + (int64_t)b * Cout + n);
        *reinterpret_cast<float2*>(trow + n) =
            make_float2(acc[i][j][2 * h] * d.x, acc[i][j][2 * h + 1] * d.y);
      }
    }
  }
}

struct BlurTaps {
  float k[4];  // flipped 1-D taps: out[o] = sum_t k[t] * T[o - 1 + t]
};

__global__ void up_blur_epilogue_kernel(const float* __restrict__ t_in,  // (B, 2H+1, 2W+1, C)
                                        const float* __restrict__ noise,  // (Nb, 2H, 2W)
                                        int64_t noise_bs,
                                        const float* __restrict__ nw,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out,  // (B, 2H, 2W, C)
                                        BlurTaps kt, int B, int H, int W,
                                        int C) {
  const int C4 = C >> 2;
  const int64_t total = (int64_t)B * H * W * C4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C4) * 4;
  int64_t r = i / C4;
  const int xb = (int)(r % W);  // output columns 2 xb, 2 xb + 1
  r /= W;
  const int yb = (int)(r % H);  // output rows 2 yb, 2 yb + 1
  const int b = (int)(r / H);
  const int TH = 2 * H + 1, TW = 2 * W + 1;
  const int OH = 2 * H, OW = 2 * W;

  float4 o[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) o[a][e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // T rows 2 yb - 1 .. 2 yb + 3 and columns 2 xb - 1 .. 2 xb + 3
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int Y = 2 * yb - 1 + u;
    if (Y < 0 || Y >= TH) continue;
    const float* trow = t_in + ((int64_t)b * TH + Y) * TW * C + c;
    float4 v[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int X = 2 * xb - 1 + e;
      v[e] = (X >= 0 && X < TW)
                 ? *reinterpret_cast<const float4*>(trow + (int64_t)X * C)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // horizontal pass for output column 2 xb + e
      float4 hz = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        hz.x += kt.k[t] * v[e + t].x;
        hz.y += kt.k[t] * v[e + t].y;
        hz.z += kt.k[t] * v[e + t].z;
        hz.w += kt.k[t] * v[e + t].w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {  // vertical tap u - a of output row 2 yb + a
        const int t = u - a;
        if (t < 0 || t > 3) continue;
        o[a][e].x += kt.k[t] * hz.x;
        o[a][e].y += kt.k[t] * hz.y;
        o[a][e].z += kt.k[t] * hz.z;
        o[a][e].w += kt.k[t] * hz.w;
      }
    }
  }

  const float nwv = *nw;
  const float4 bb = *reinterpret_cast<const float4*>(bias + c);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oy = 2 * yb + a, ox = 2 * xb + e;
      const float nz = nwv * noise[(int64_t)b * noise_bs + (int64_t)oy * OW + ox];
      float v[4] = {o[a][e].x, o[a][e].y, o[a][e].z, o[a][e].w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float s = v[k] + nz + bv[k];
        v[k] = (s >= 0.f ? s : 0.2f * s) * SQRT2;
      }
      *reinterpret_cast<float4*>(out + (((int64_t)b * OH + oy) * OW + ox) * C + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int gk_styled_up_conv3x3(const float* xm, const float* w,
                                    const float* demod, const float* noise,
                                    long long noise_bs, const float* nw,
                                    const float* bias, float* scratch,
                                    float* out, int B, int H, int W, int Cin,
                                    int Cout, float k0, float k1, float k2,
                                    float k3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // > 48 KB of dynamic shared memory; cheap and idempotent, so every launch
  cudaError_t e = cudaFuncSetAttribute(
      up_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(up_gemm_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  PhaseTiles pt;
  pt.tiles_n = (Cout + BN - 1) / BN;
  pt.first[0] = 0;
  for (int p = 0; p < 4; ++p) {
    const int rows = H + 1 - (p >> 1), cols = W + 1 - (p & 1);
    const int tiles_m = (B * rows * cols + BM - 1) / BM;
    pt.first[p + 1] = pt.first[p] + tiles_m * pt.tiles_n;
  }
  up_gemm_kernel<<<pt.first[4], NT, SMEM_BYTES, s>>>(xm, w, demod, scratch, pt,
                                                     B, H, W, Cin, Cout);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the blur taps flipped once here: true convolution
  BlurTaps kt = {{k3, k2, k1, k0}};
  const int64_t total = (int64_t)B * H * W * (Cout / 4);
  const int threads = 256;
  up_blur_epilogue_kernel<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, s>>>(scratch, noise, noise_bs, nw, bias,
                                             out, kt, B, H, W, Cout);
  return (int)cudaGetLastError();
}
