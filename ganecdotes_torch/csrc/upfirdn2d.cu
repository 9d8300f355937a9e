// upfirdn2d without the subsample: zero-insertion upsample (up 1 or 2 per
// axis) -> pad (negative = crop) -> true 2-D convolution with an FIR kernel,
// on NHWC float32.
//
// Replaces ganecdotes_tpu/ops/upfirdn2d_pallas.py::upfirdn2d_pallas (_forward,
// the pallas_call at upfirdn2d_pallas.py:196), which covers only the blur
// (up = 1); this kernel also takes up = 2, as the original CUDA kernel did.
// On the serving path it runs the to_rgb skip upsamples (up = 2, 4x4 taps,
// C = 3). down = 1: no path of the port subsamples yet.
//
// Semantics (ops/upfirdn2d.py::upfirdn2d_ref): output (oy, ox) reads the
// padded, upsampled signal at oy + ky, which holds x[iy] when
// (oy + ky - pad_y0) = iy*up, and zero elsewhere (including the up-1 zeros
// torch appends after the last sample). True convolution: tap ky of the sum
// uses kernel row kh-1-ky.
//
// Bound: bytes. At up = 2 each output reads 4 live taps (8 flops) for 4
// bytes written and 1 byte read, so the pass is a copy-speed stream.
// Design: one thread per output element, channel fastest, so neighbouring
// threads touch neighbouring addresses for any C; taps arrive by value in
// the kernel's parameter space (constant cache, no device copy); taps that
// land on inserted zeros or padding are skipped, not multiplied.
#include <cuda_runtime.h>
#include <stdint.h>

#define GK_KMAX 8

struct Taps {
  float k[GK_KMAX * GK_KMAX];
};

namespace {

__global__ void upfirdn2d_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int B, int H, int W,
                                 int C, int OH, int OW, int up_x, int up_y,
                                 int pad_x0, int pad_y0, Taps taps, int kh,
                                 int kw) {
  const int64_t total = (int64_t)B * OH * OW * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int hu = H * up_y, wu = W * up_x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int c = (int)(i % C);
    int64_t r = i / C;
    int ox = (int)(r % OW);
    r /= OW;
    int oy = (int)(r % OH);
    int b = (int)(r / OH);
    float acc = 0.f;
    for (int ky = 0; ky < kh; ++ky) {
      int my = oy + ky - pad_y0;
      if (my < 0 || my >= hu || my % up_y) continue;
      int iy = my / up_y;
      const float* row = x + ((int64_t)b * H + iy) * W * C + c;
      const float* krow = taps.k + (kh - 1 - ky) * kw;
      for (int kx = 0; kx < kw; ++kx) {
        int mx = ox + kx - pad_x0;
        if (mx < 0 || mx >= wu || mx % up_x) continue;
        acc += row[(int64_t)(mx / up_x) * C] * krow[kw - 1 - kx];
      }
    }
    y[i] = acc;
  }
}

}  // namespace

extern "C" int gk_upfirdn2d(const float* x, float* y, int B, int H, int W,
                            int C, int OH, int OW, int up_x, int up_y,
                            int pad_x0, int pad_y0, Taps taps, int kh, int kw,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int64_t total = (int64_t)B * OH * OW * C;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  upfirdn2d_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      x, y, B, H, W, C, OH, OW, up_x, up_y, pad_x0, pad_y0, taps, kh, kw);
  return (int)cudaGetLastError();
}
