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
// Design of the GEMM: the 3xTF32 tensor-core main loop of tf32x3.cuh
// (plain TF32 would keep about 3 digits over K = 2048 and is not offered).
// A block owns a 128 x 128 output tile of one phase class; A is the
// gathered x * s pixels of a tap, B the tap's weight slice (the wrapper
// passes w as (3, 3, Cout, Cin)). One flat grid covers the four classes
// with the 4-tap tiles first and the 1-tap tiles last, so the short tiles
// fill the SMs the long ones leave idle at the end.
//
// The blur kernel is bound by bytes (16 taps per output, reading T once
// from device memory at best): one thread owns a 2 x 2 block of outputs and
// 4 channels, reads the 5 x 5 window of T it needs once, blurs it
// separably and writes the 16 outputs as four 16-byte vectors.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float SQRT2 = 1.4142135623730951f;

struct PhaseTiles {
  int first[5];  // first block of each phase class, first[4] = grid size
  int tiles_n;
};

__global__ void __launch_bounds__(NT, 1)
up_gemm_kernel(const float* __restrict__ xm,     // (B, H, W, Cin)
               const float* __restrict__ w,      // (3, 3, Cout, Cin)
               const float* __restrict__ demod,  // (B, Cout)
               float* __restrict__ t_out,        // (B, 2H+1, 2W+1, Cout)
               PhaseTiles pt, int B, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];

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

  // class pixel (y, x) reads x pixel (y - ty, x - tx) through tap (ty, tx)
  const ARows a = a_rows(m0, M, Hp, Wp, H, W);
  float acc[4][4][4];
  gemm(acc, smem, ntaps, Cin, [&](float* stage, int tap, int c0) {
    const int ty = ntx == 2 ? tap >> 1 : tap, tx = ntx == 2 ? tap & 1 : 0;
    const int ky = py ? 1 : 2 * ty, kx = px ? 1 : 2 * tx;
    load_stage(stage, xm, w + (int64_t)(ky * 3 + kx) * Cout * Cin, a, -ty,
               -tx, c0, n0, H, W, Cin, Cout);
  });

  // epilogue: demod, then T[b, 2y + py, 2x + px, n] as float2 pairs
  const int TH = 2 * H + 1, TW = 2 * W + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + frag_row(i, h);
      if (m >= M) continue;
      const int b = m / HWp;
      const int r = m - b * HWp;
      const int y = r / Wp;
      const int x = r - y * Wp;
      float* trow =
          t_out + (((int64_t)b * TH + 2 * y + py) * TW + 2 * x + px) * Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + frag_col(j);
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
  cudaError_t e = set_smem(up_gemm_kernel);
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
