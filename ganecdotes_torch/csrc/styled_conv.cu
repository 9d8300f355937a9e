// StyleGAN2's StyledConv body, modulated 3x3 conv with its whole epilogue:
//
//   out = lrelu(demod * conv3x3(x * s, W) + nw * noise + bias, 0.2) * sqrt(2)
//
// Replaces ganecdotes_tpu/ops/modulated_conv_pallas.py::styled_conv3x3
// (_pallas_forward, the pallas_call at :212). The upsampling body
// (styled_up_conv3x3) has its own kernels in styled_up_conv.cu.
//
// The wrapper materialises x * s (as the JAX kernel does); this kernel
// reads it once per tap from L2.
//
// Bound: operations. 2*9*Cin*Cout flops per output pixel against
// (Cin + Cout)*4 bytes: hundreds of flops per byte at the serving widths,
// far above the fp32 balance point (67 TFLOP/s over 3.35 TB/s = 20).
// Design: an implicit GEMM in fp32 on the SIMT cores. M = output pixels,
// N = Cout, K = 9 taps x Cin. A block owns a 128 x 128
// output tile; 256 threads each hold an 8 x 8 register tile, so every
// shared-memory value loaded feeds 8 FMAs. K advances in chunks of 8
// channels of one tap: the A chunk is gathered from the (tile + halo) pixels
// of x * s with zero fill outside the image (the 'same' padding never
// exists in memory), the B chunk is a slice of the HWIO weight, which is
// already K x N row-major. Both chunks are double-buffered in shared memory
// and the next one is fetched into registers while the current one is
// multiplied, so one barrier per chunk suffices. The epilogue applies
// demod, noise, bias, leaky-ReLU and sqrt(2) in registers before the single
// 16-byte-vector write. Shapes are free: pixel rows past M and channels
// past Cout are masked, so the 4x4 first layer (Cin = 512) runs here too.
// Requires Cin % 4 == 0, Cout % 4 == 0 and 16-byte-aligned pointers (the
// wrapper checks). The tensor-core main loop of styled_up_conv.cu is the
// next step for this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int NT = 256;
constexpr float SQRT2 = 1.4142135623730951f;

__global__ void __launch_bounds__(NT, 2)
styled_conv3x3_kernel(const float* __restrict__ xm,     // (B, H, W, Cin)
                      const float* __restrict__ w,      // (3, 3, Cin, Cout)
                      const float* __restrict__ demod,  // (B, Cout)
                      const float* __restrict__ noise,  // (Nb, OH, OW)
                      int64_t noise_bs,                 // 0: broadcast over B
                      const float* __restrict__ nw,     // scalar
                      const float* __restrict__ bias,   // (Cout,)
                      float* __restrict__ out,          // (B, OH, OW, Cout)
                      int B, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: one pixel row, four consecutive channels
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int am = m0 + a_row;
  const bool a_in = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (a_in) {
    ab = am / HW;
    int r = am - ab * HW;
    ay = r / W;
    ax = r - ay * W;
  }
  // B loader: one K row, four consecutive output channels
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const bool b_in = n0 + b_n < Cout;

  const int kchunks = (Cin + BK - 1) / BK;
  const int T = 9 * kchunks;

  float4 a_reg, b_reg;
  auto fetch = [&](int t) {
    int tap = t / kchunks;
    int ci0 = (t - tap * kchunks) * BK;
    int dy = tap / 3;
    int dx = tap - dy * 3;
    int iy = ay + dy - 1;
    int ix = ax + dx - 1;
    int ci = ci0 + a_k;
    a_reg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_in && ci < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W) {
      a_reg = *reinterpret_cast<const float4*>(
          xm + (((int64_t)ab * H + iy) * W + ix) * Cin + ci);
    }
    int kk = ci0 + b_k;
    b_reg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b_in && kk < Cin) {
      b_reg = *reinterpret_cast<const float4*>(
          w + ((int64_t)tap * Cin + kk) * Cout + n0 + b_n);
    }
  };
  auto stash = [&](int buf) {
    As[buf][a_k + 0][a_row] = a_reg.x;
    As[buf][a_k + 1][a_row] = a_reg.y;
    As[buf][a_k + 2][a_row] = a_reg.z;
    As[buf][a_k + 3][a_row] = a_reg.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = b_reg;
  };

  // compute mapping: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, likewise
  // columns with tx, so the float4 reads of a warp are contiguous
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + 1 < T) fetch(t + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < T) stash(cur ^ 1);
    __syncthreads();
  }

  // epilogue
  const float nwv = *nw;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    int b = m / HW;
    int r = m - b * HW;
    int y = r / W;
    int x = r - y * W;
    int64_t opix = ((int64_t)b * H + y) * W + x;
    float nz = nwv * noise[(int64_t)b * noise_bs + (int64_t)y * W + x];
    float* orow = out + opix * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int n = n0 + h * 64 + tx * 4;
      if (n >= Cout) continue;
      float4 d = *reinterpret_cast<const float4*>(demod + (int64_t)b * Cout + n);
      float4 bb = *reinterpret_cast<const float4*>(bias + n);
      float v[4] = {acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]};
      float dv[4] = {d.x, d.y, d.z, d.w};
      float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float o = v[q] * dv[q];
        o = o + nz;
        o = o + bv[q];
        v[q] = (o >= 0.f ? o : 0.2f * o) * SQRT2;
      }
      *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int gk_styled_conv3x3(const float* xm, const float* w,
                                 const float* demod, const float* noise,
                                 long long noise_bs, const float* nw,
                                 const float* bias, float* out, int B, int H,
                                 int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  styled_conv3x3_kernel<<<grid, NT, 0, s>>>(
      xm, w, demod, noise, noise_bs, nw, bias, out, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
