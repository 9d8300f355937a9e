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
// far above the balance point of the tensor cores.
// Design: an implicit GEMM on the 3xTF32 tensor-core main loop of
// tf32x3.cuh, M = output pixels, N = Cout, K = 9 taps x Cin. Tap (dy, dx)
// reads pixel (y + dy - 1, x + dx - 1) with zero fill outside the image,
// so the 'same' padding never exists in memory; the weights come as
// (3, 3, Cout, Cin), k contiguous per output channel. The whole epilogue
// (demod, noise, bias, leaky-ReLU, sqrt(2)) runs in registers on the MMA
// fragments before the single write. Shapes are free: pixel rows past M
// and channels past Cout are masked. Small M (the 4x4 to 16x16 layers at
// B = 8, every early layer at B = 1) leaves most SMs idle while a few
// blocks walk K = 9 * Cin, so the wrapper may split the 9 taps 3 or 9 ways
// over blockIdx.z: each split writes its raw sums to a scratch tensor and
// styled_conv_epilogue_kernel sums the splits in order, then runs the
// epilogue. Requires Cin % 4 == 0, Cout % 4 == 0 and 16-byte-aligned
// pointers (the wrapper checks).
//
// On bfloat16 activations (gk_styled_conv3x3_bf16) the same design runs on
// the bf16 main loop of bf16_mma.cuh: x * s and W in bf16, one pass of
// bf16 MMAs into fp32 accumulators, the epilogue in fp32 and one rounding
// to bf16 on the store, as the JAX kernel's bf16 instance does
// (modulated_conv_pallas.py:166-184). Its tile is 128 pixels by 16, 32, 64
// or 128 output channels (bf16mma::tile_n), so one body serves every Cout
// from 16 to 512. Requires Cin % 8 == 0 and Cout % 8 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float SQRT2 = 1.4142135623730951f;

// demod, noise, bias, leaky-ReLU and sqrt(2), in the plain version's order
__device__ __forceinline__ float finish(float acc, float d, float nz, float bias) {
  float o = acc * d;
  o = o + nz;
  o = o + bias;
  return (o >= 0.f ? o : 0.2f * o) * SQRT2;
}

__global__ void __launch_bounds__(NT, 1)
styled_conv3x3_kernel(const float* __restrict__ xm,     // (B, H, W, Cin)
                      const float* __restrict__ w,      // (3, 3, Cout, Cin)
                      const float* __restrict__ demod,  // (B, Cout)
                      const float* __restrict__ noise,  // (Nb, H, W)
                      int64_t noise_bs,                 // 0: broadcast over B
                      const float* __restrict__ nw,     // scalar
                      const float* __restrict__ bias,   // (Cout,)
                      float* __restrict__ out,          // (B, H, W, Cout)
                      float* __restrict__ part,  // (nsplit, M, Cout) if nsplit > 1
                      int nsplit, int B, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];

  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int t0 = 9 * blockIdx.z / nsplit, t1 = 9 * (blockIdx.z + 1) / nsplit;

  const ARows a = a_rows(m0, M, H, W, H, W);
  float acc[4][4][4];
  gemm(acc, smem, t1 - t0, Cin, [&](float* stage, int tap, int c0) {
    tap += t0;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    load_stage(stage, xm, w + (int64_t)tap * Cout * Cin, a, dy - 1, dx - 1,
               c0, n0, H, W, Cin, Cout);
  });

  if (nsplit > 1) {  // this split's raw sums
    float* pz = part + (int64_t)blockIdx.z * M * Cout;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + frag_row(i, h);
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + frag_col(j);
          if (n < Cout)
            *reinterpret_cast<float2*>(pz + (int64_t)m * Cout + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }

  const float nwv = *nw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + frag_row(i, h);
      if (m >= M) continue;
      const int b = m / HW;
      const int r = m - b * HW;
      const float nz = nwv * noise[(int64_t)b * noise_bs + r];
      float* orow = out + (int64_t)m * Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + frag_col(j);
        if (n >= Cout) continue;
        const float2 d =
            *reinterpret_cast<const float2*>(demod + (int64_t)b * Cout + n);
        const float2 bb = *reinterpret_cast<const float2*>(bias + n);
        *reinterpret_cast<float2*>(orow + n) =
            make_float2(finish(acc[i][j][2 * h], d.x, nz, bb.x),
                        finish(acc[i][j][2 * h + 1], d.y, nz, bb.y));
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

// out = the epilogue of the splits' sums, added in split order; a thread
// takes 4 channels of one pixel
template <class OutT>
__global__ void styled_conv_epilogue_kernel(const float* __restrict__ part,
                                            int nsplit,
                                            const float* __restrict__ demod,
                                            const float* __restrict__ noise,
                                            int64_t noise_bs,
                                            const float* __restrict__ nw,
                                            const float* __restrict__ bias,
                                            OutT* __restrict__ out, int M,
                                            int HW, int Cout) {
  const int C4 = Cout >> 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)M * C4) return;
  const int m = (int)(i / C4), n = (int)(i - (int64_t)m * C4) * 4;
  const int64_t at = (int64_t)m * Cout + n;
  float4 a = *reinterpret_cast<const float4*>(part + at);
  for (int z = 1; z < nsplit; ++z) {
    const float4 p =
        *reinterpret_cast<const float4*>(part + (int64_t)z * M * Cout + at);
    a.x += p.x;
    a.y += p.y;
    a.z += p.z;
    a.w += p.w;
  }
  const int b = m / HW;
  const float nz = *nw * noise[(int64_t)b * noise_bs + (m - b * HW)];
  const float4 d = *reinterpret_cast<const float4*>(demod + (int64_t)b * Cout + n);
  const float4 bb = *reinterpret_cast<const float4*>(bias + n);
  store4(out + at, finish(a.x, d.x, nz, bb.x), finish(a.y, d.y, nz, bb.y),
         finish(a.z, d.z, nz, bb.z), finish(a.w, d.w, nz, bb.w));
}

// The bf16 body: the 9-tap implicit GEMM on bf16_mma.cuh, a BN-wide tile.
template <int BN>
__global__ void __launch_bounds__(bf16mma::NT)
styled_conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xm,  // (B, H, W, Cin)
                           const __nv_bfloat16* __restrict__ w,   // (3, 3, Cout, Cin)
                           const float* __restrict__ demod,       // (B, Cout)
                           const float* __restrict__ noise,       // (Nb, H, W)
                           int64_t noise_bs,
                           const float* __restrict__ nw,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out,       // (B, H, W, Cout)
                           float* __restrict__ part,  // (nsplit, M, Cout) if nsplit > 1
                           int nsplit, int B, int H, int W, int Cin, int Cout) {
  namespace bm = bf16mma;
  using TL = bm::Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bf16);

  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * bm::BM;
  const int n0 = blockIdx.y * BN;
  const int t0 = 9 * blockIdx.z / nsplit, t1 = 9 * (blockIdx.z + 1) / nsplit;

  const bm::ARows a = bm::a_rows(m0, M, H, W, H, W);
  float acc[TL::MI][TL::NJ][4];
  bm::gemm<BN>(acc, smem, t1 - t0, Cin, [&](__nv_bfloat16* stage, int tap, int c0) {
    tap += t0;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    bm::load_stage<BN>(stage, xm, w + (int64_t)tap * Cout * Cin, a, dy - 1,
                       dx - 1, c0, n0, H, W, Cin, Cout);
  });

  if (nsplit > 1) {  // this split's raw sums
    float* pz = part + (int64_t)blockIdx.z * M * Cout;
#pragma unroll
    for (int i = 0; i < TL::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + bm::frag_row<BN>(i, h);
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) {
          const int n = n0 + bm::frag_col<BN>(j);
          if (n < Cout)
            *reinterpret_cast<float2*>(pz + (int64_t)m * Cout + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }

  const float nwv = *nw;
#pragma unroll
  for (int i = 0; i < TL::MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + bm::frag_row<BN>(i, h);
      if (m >= M) continue;
      const int b = m / HW;
      const int r = m - b * HW;
      const float nz = nwv * noise[(int64_t)b * noise_bs + r];
      __nv_bfloat16* orow = out + (int64_t)m * Cout;
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) {
        const int n = n0 + bm::frag_col<BN>(j);
        if (n >= Cout) continue;
        const float2 d =
            *reinterpret_cast<const float2*>(demod + (int64_t)b * Cout + n);
        const float2 bb = *reinterpret_cast<const float2*>(bias + n);
        *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(
            finish(acc[i][j][2 * h], d.x, nz, bb.x),
            finish(acc[i][j][2 * h + 1], d.y, nz, bb.y));
      }
    }
  }
}

template <int BN>
int launch_bf16(const __nv_bfloat16* xm, const __nv_bfloat16* w,
                const float* demod, const float* noise, long long noise_bs,
                const float* nw, const float* bias, __nv_bfloat16* out,
                float* part, int nsplit, int B, int H, int W, int Cin,
                int Cout, cudaStream_t s) {
  auto kernel = styled_conv3x3_bf16_kernel<BN>;
  const int smem = bf16mma::Tile<BN>::SMEM_BYTES;
  cudaError_t e = bf16mma::set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int M = B * H * W;
  dim3 grid((M + bf16mma::BM - 1) / bf16mma::BM, (Cout + BN - 1) / BN, nsplit);
  kernel<<<grid, bf16mma::NT, smem, s>>>(xm, w, demod, noise, noise_bs, nw,
                                         bias, out, part, nsplit, B, H, W,
                                         Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gk_styled_conv3x3(const float* xm, const float* w,
                                 const float* demod, const float* noise,
                                 long long noise_bs, const float* nw,
                                 const float* bias, float* out, float* part,
                                 int nsplit, int B, int H, int W, int Cin,
                                 int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit != 1 && nsplit != 3 && nsplit != 9) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(styled_conv3x3_kernel);
  if (e != cudaSuccess) return (int)e;
  const int M = B * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, nsplit);
  styled_conv3x3_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      xm, w, demod, noise, noise_bs, nw, bias, out, part, nsplit, B, H, W,
      Cin, Cout);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  const int64_t total = (int64_t)M * (Cout / 4);
  styled_conv_epilogue_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, nsplit, demod, noise, noise_bs, nw, bias, out, M, H * W, Cout);
  return (int)cudaGetLastError();
}

// The bf16 entry: xm, w and out bf16; demod, noise, nw, bias and the split
// scratch float32. ``bn`` is the tile width (16, 32, 64 or 128).
extern "C" int gk_styled_conv3x3_bf16(const void* xm, const void* w,
                                      const float* demod, const float* noise,
                                      long long noise_bs, const float* nw,
                                      const float* bias, void* out, float* part,
                                      int nsplit, int B, int H, int W, int Cin,
                                      int Cout, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nsplit != 1 && nsplit != 3 && nsplit != 9) || Cin % 8 || Cout % 8 ||
      bn != bf16mma::tile_n(Cout))
    return (int)cudaErrorInvalidValue;
  const auto* x16 = static_cast<const __nv_bfloat16*>(xm);
  const auto* w16 = static_cast<const __nv_bfloat16*>(w);
  auto* o16 = static_cast<__nv_bfloat16*>(out);
  int rc;
  switch (bn) {
    case 16:
      rc = launch_bf16<16>(x16, w16, demod, noise, noise_bs, nw, bias, o16,
                           part, nsplit, B, H, W, Cin, Cout, s);
      break;
    case 32:
      rc = launch_bf16<32>(x16, w16, demod, noise, noise_bs, nw, bias, o16,
                           part, nsplit, B, H, W, Cin, Cout, s);
      break;
    case 64:
      rc = launch_bf16<64>(x16, w16, demod, noise, noise_bs, nw, bias, o16,
                           part, nsplit, B, H, W, Cin, Cout, s);
      break;
    default:
      rc = launch_bf16<128>(x16, w16, demod, noise, noise_bs, nw, bias, o16,
                            part, nsplit, B, H, W, Cin, Cout, s);
  }
  if (rc != 0 || nsplit == 1) return rc;
  const int M = B * H * W;
  const int64_t total = (int64_t)M * (Cout / 4);
  styled_conv_epilogue_kernel<__nv_bfloat16>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          part, nsplit, demod, noise, noise_bs, nw, bias, o16, M, H * W, Cout);
  return (int)cudaGetLastError();
}
