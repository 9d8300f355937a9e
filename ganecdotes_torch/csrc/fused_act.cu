// Fused bias + leaky-ReLU + scale: y = leaky_relu(x + bias[c], slope) * scale.
//
// Replaces ganecdotes_tpu/ops/fused_act.py::fused_leaky_relu_pallas
// (_fused_act_pallas_impl, the pallas_call at fused_act.py:53), forward only.
//
// Bound: bytes. Two flops per element against 8 bytes moved (x read once,
// y written once; bias stays in L1), far below the card's ~20 flop/byte
// fp32 balance point. Design: one grid-stride elementwise pass; a warp
// reads and writes 128 contiguous bytes per step. The bias index is
// computed per element, so no layout beyond row-major (N, C) is assumed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fused_leaky_relu_kernel(const float* __restrict__ x,
                                        const float* __restrict__ bias,
                                        float* __restrict__ y, int64_t n, int c,
                                        float slope, float scale) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = x[i];
    if (bias) v += bias[i % c];
    y[i] = (v >= 0.f ? v : v * slope) * scale;
  }
}

}  // namespace

extern "C" int gk_fused_leaky_relu(const float* x, const float* bias, float* y,
                                   long long n, int c, float slope, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks/SM
  fused_leaky_relu_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      x, bias, y, n, c, slope, scale);
  return (int)cudaGetLastError();
}
