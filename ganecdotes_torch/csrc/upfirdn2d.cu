// upfirdn2d with a separable FIR on NHWC float32: zero-insertion upsample by
// up (1 or 2 per axis) -> pad (negative = crop) -> true convolution with
// taps_y (x) taps_x, 1 to 16 taps per axis -> subsample by down (1 or 2 per
// axis) from index 0.
//
// Replaces ganecdotes_tpu/ops/upfirdn2d_pallas.py::upfirdn2d_pallas (_forward,
// the pallas_call at upfirdn2d_pallas.py:196), the separable blur at
// up = down = 1, widened to the FIRs the JAX package computes through
// upfirdn2d (ganecdotes_tpu/ops/upfirdn2d.py:209): the to_rgb skip upsample
// (up 2, 4 taps, C = 3), the discriminator's blurs (4 taps, C = 128-512),
// ADA's SYM6 wavelet passes (12 taps on one axis, up 2 or down 2, C = 3) and
// every backward of these, which is this same function with up and down
// swapped and the taps flipped. A 1-D tap vector of at most 16 covers them
// all: SYM6 is the longest, at 12.
//
// Semantics (ops/upfirdn2d.py::upfirdn2d_ref), per axis: output o sums
// k[K-1-t] * U[o*down + t - pad0] over t < K, where U[m] = x[m/up] when up
// divides m and m/up is a sample, and 0 elsewhere (the up-1 zeros torch
// appends after the last sample included).
//
// Bound: bytes. Each output costs kh/up_y + kw/up_x multiply-adds for 4
// bytes written and 4/(up_x*up_y)*(down_x*down_y) read; at 4 taps that is
// far below the card's 20 flops per byte of fp32 SIMT.
//
// Design. One block computes a tile of toh output rows x tow output columns
// x ct channels (the wrapper plans it: ops/upfirdn2d.py::plan):
//   1. it stages the tile's whole input footprint, halo included, in shared
//      memory once: cp.async, 16 bytes a copy where C % 4 == 0 (4 channels a
//      thread), 4 bytes otherwise (ADA's and to_rgb's C = 3, over the
//      flattened (column, channel) row, so a warp still reads consecutive
//      addresses); the hardware zero-fills samples outside the image;
//   2. the vertical pass writes toh rows x the staged columns to a second
//      shared buffer (skipped for a single tap at up = down = 1, whose tap
//      the wrapper folds into taps_x);
//   3. the horizontal pass reads that buffer and writes the outputs, a
//      warp's stores consecutive along (column, channel).
// So the row-pass intermediate never touches device memory, as in the TPU
// kernel, and each input is read from device memory once (halos from L2).
// up and down are template parameters: at up = 2 an output reads only its
// live taps (every second one, from the phase of its row or column, fixed
// once per output), so no tap tests a remainder; at down = 2 the footprint
// is twice the tile. All index math is 32-bit (every tensor holds fewer than
// 2^31 elements) and the flattened (row, column) walks step without a
// division. The taps pass by value in the launch's parameter space
// (__grid_constant__: read in place through the constant cache, no copy).
//
// bfloat16 (gk_upfirdn2d_bf16): the same kernel on bf16 storage. Staging
// converts each input to fp32 on its way into shared memory (plain 8- or
// 2-byte loads: cp.async copies whole bytes, and a bf16 sample is narrower
// than its 4-byte minimum), both passes run in fp32 as they do for float32,
// and each output is rounded once to bf16 on the store. The bytes halve.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GK_KMAX 16

struct Taps {
  float ky[GK_KMAX];
  float kx[GK_KMAX];
  int kh;
  int kw;
};

namespace {

struct Params {
  int H, W, C, OH, OW;
  int pad_x0, pad_y0;
  int toh, tow, ct;  // the block's output tile and channel slice
  int ih, iw;        // its staged input rows and columns
  int slices;        // channel slices per image
  int vpass;         // 0: a single tap at up = down = 1, folded into kx
  Taps taps;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  __device__ static void copy(uint32_t dst, const float* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0));
  }
  __device__ static T zero() { return 0.f; }
  __device__ static void fma(T& acc, float k, T v) { acc = fmaf(k, v, acc); }
};

template <>
struct Vec<4> {
  using T = float4;
  __device__ static void copy(uint32_t dst, const float* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(T& acc, float k, T v) {
    acc.x = fmaf(k, v.x, acc.x);
    acc.y = fmaf(k, v.y, acc.y);
    acc.z = fmaf(k, v.z, acc.z);
    acc.w = fmaf(k, v.w, acc.w);
  }
};

using bf16 = __nv_bfloat16;

// one staging copy of VEC channels into shared memory (fp32 there)
template <int VEC>
__device__ __forceinline__ void stage_copy(float* dst, const float* src, bool ok) {
  Vec<VEC>::copy(smem_addr(dst), src, ok);
}

template <int VEC>
__device__ __forceinline__ void stage_copy(float* dst, const bf16* src, bool ok) {
  if constexpr (VEC == 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const uint2 t = *reinterpret_cast<const uint2*>(src);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
      v = make_float4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    *dst = ok ? __bfloat162float(*src) : 0.f;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The walk of a flattened (row, column) range by a stride of whole positions:
// advances without a division.
struct Walk {
  int r, col;
  __device__ Walk(int start, int cols) : r(0), col(start) { wrap(cols); }
  __device__ void wrap(int cols) {
    while (col >= cols) {
      col -= cols;
      ++r;
    }
  }
  __device__ void step(int stride, int cols) {
    col += stride;
    wrap(cols);
  }
};

template <int UX, int DX, int UY, int DY, int VEC, class T>
__global__ void __launch_bounds__(256)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const __grid_constant__ Params p) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float smem[];
  const int ctv = p.ct / VEC;
  const int np = blockDim.x / ctv;  // positions a sweep covers (ctv | threads)
  const int cv = threadIdx.x % ctv, pos = threadIdx.x / ctv;
  const int b = blockIdx.z / p.slices;
  const int c = (blockIdx.z - b * p.slices) * p.ct + cv * VEC;
  const bool c_ok = c < p.C;
  const int oy0 = blockIdx.y * p.toh, ox0 = blockIdx.x * p.tow;
  // the first U index the tile reads per axis, its parity, and the first
  // input sample at or after it (the first staged row / column)
  const int my0 = oy0 * DY - p.pad_y0, mx0 = ox0 * DX - p.pad_x0;
  const int ey = UY == 2 ? (my0 & 1) : 0, ex = UX == 2 ? (mx0 & 1) : 0;
  const int iy0 = UY == 2 ? (my0 + ey) >> 1 : my0;
  const int ix0 = UX == 2 ? (mx0 + ex) >> 1 : mx0;
  const int pitch = p.iw * p.ct;  // floats per staged row (both buffers)
  float* in = smem;
  float* mid = p.vpass ? smem + p.ih * pitch : smem;
  const T* xb = x + b * p.H * p.W * p.C + c;

  // 1. stage the input footprint (zero outside the image)
  for (Walk s(pos, p.iw); s.r < p.ih; s.step(np, p.iw)) {
    const int iy = iy0 + s.r, ix = ix0 + s.col;
    const bool ok = c_ok && (unsigned)iy < (unsigned)p.H &&
                    (unsigned)ix < (unsigned)p.W;
    stage_copy<VEC>(in + s.r * pitch + s.col * p.ct + cv * VEC,
                    ok ? xb + (iy * p.W + ix) * p.C : x, ok);
  }
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();

  // 2. vertical pass: toh rows x iw columns into mid
  const float* ky = p.taps.ky;
  const int kh = p.taps.kh;
  if (p.vpass) {
    for (Walk s(pos, p.iw); s.r < p.toh; s.step(np, p.iw)) {
      V acc = Vec<VEC>::zero();
      const float* src = in + s.col * p.ct + cv * VEC;
      if (UY == 1) {
        src += s.r * DY * pitch;
        for (int t = 0; t < kh; ++t, src += pitch)
          Vec<VEC>::fma(acc, ky[kh - 1 - t], *reinterpret_cast<const V*>(src));
      } else {
        const int t0 = (ey + s.r) & 1;  // the row's first live tap
        src += ((s.r + t0 - ey) >> 1) * pitch;
        for (int t = t0; t < kh; t += 2, src += pitch)
          Vec<VEC>::fma(acc, ky[kh - 1 - t], *reinterpret_cast<const V*>(src));
      }
      *reinterpret_cast<V*>(mid + s.r * pitch + s.col * p.ct + cv * VEC) = acc;
    }
    __syncthreads();
  }

  // 3. horizontal pass: toh rows x tow columns to the output
  const float* kx = p.taps.kx;
  const int kw = p.taps.kw;
  if (c_ok) {
    for (Walk s(pos, p.tow); s.r < p.toh; s.step(np, p.tow)) {
      const int oy = oy0 + s.r, ox = ox0 + s.col;
      if (oy >= p.OH) break;
      if (ox >= p.OW) continue;
      V acc = Vec<VEC>::zero();
      const float* src = mid + s.r * pitch + cv * VEC;
      if (UX == 1) {
        src += s.col * DX * p.ct;
        for (int t = 0; t < kw; ++t, src += p.ct)
          Vec<VEC>::fma(acc, kx[kw - 1 - t], *reinterpret_cast<const V*>(src));
      } else {
        const int t0 = (ex + s.col) & 1;  // the column's first live tap
        src += ((s.col + t0 - ex) >> 1) * p.ct;
        for (int t = t0; t < kw; t += 2, src += p.ct)
          Vec<VEC>::fma(acc, kx[kw - 1 - t], *reinterpret_cast<const V*>(src));
      }
      store_out(y + ((b * p.OH + oy) * p.OW + ox) * p.C + c, acc);
    }
  }
}

template <int UX, int DX, int UY, int DY, int VEC, class T>
int launch(const T* x, T* y, int B, const Params& p, int threads,
           cudaStream_t s) {
  auto kernel = upfirdn2d_kernel<UX, DX, UY, DY, VEC, T>;
  const int smem = (p.ih * p.iw + (p.vpass ? p.toh * p.iw : 0)) * p.ct * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.OW + p.tow - 1) / p.tow, (p.OH + p.toh - 1) / p.toh,
            B * p.slices);
  kernel<<<grid, threads, smem, s>>>(x, y, p);
  return (int)cudaGetLastError();
}

// (up, down) of one axis as an index: (1, 1) -> 0, (2, 1) -> 1, (1, 2) -> 2
inline int axis_case(int up, int down) {
  if (up == 1 && down == 1) return 0;
  if (up == 2 && down == 1) return 1;
  if (up == 1 && down == 2) return 2;
  return -1;
}

template <int UX, int DX, int UY, int DY, class T>
int by_vec(const T* x, T* y, int B, const Params& p, int vec,
           int threads, cudaStream_t s) {
  return vec == 4 ? launch<UX, DX, UY, DY, 4>(x, y, B, p, threads, s)
                  : launch<UX, DX, UY, DY, 1>(x, y, B, p, threads, s);
}

template <int UX, int DX, class T>
int by_y(const T* x, T* y, int B, const Params& p, int cy, int vec,
         int threads, cudaStream_t s) {
  switch (cy) {
    case 0:
      return by_vec<UX, DX, 1, 1>(x, y, B, p, vec, threads, s);
    case 1:
      return by_vec<UX, DX, 2, 1>(x, y, B, p, vec, threads, s);
    default:
      return by_vec<UX, DX, 1, 2>(x, y, B, p, vec, threads, s);
  }
}

template <class T>
int dispatch(const T* x, T* y, int B, int H, int W, int C, int OH, int OW,
             int up_x, int up_y, int down_x, int down_y, int pad_x0,
             int pad_y0, int toh, int tow, int ct, int ih, int iw, int vec,
             int threads, int vpass, const Taps& taps, void* stream) {
  const int cx = axis_case(up_x, down_x), cy = axis_case(up_y, down_y);
  const int slices = (C + ct - 1) / ct;
  if (cx < 0 || cy < 0 || taps.kh < 1 || taps.kh > GK_KMAX || taps.kw < 1 ||
      taps.kw > GK_KMAX || (vec != 1 && vec != 4) || ct % vec ||
      threads > 256 || threads % (ct / vec) || (OH + toh - 1) / toh > 65535 ||
      B * slices > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{H, W, C, OH, OW, pad_x0, pad_y0, toh, tow, ct, ih, iw, slices,
           vpass, taps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cx) {
    case 0:
      return by_y<1, 1>(x, y, B, p, cy, vec, threads, s);
    case 1:
      return by_y<2, 1>(x, y, B, p, cy, vec, threads, s);
    default:
      return by_y<1, 2>(x, y, B, p, cy, vec, threads, s);
  }
}

}  // namespace

// The tile (toh, tow, ct, ih, iw, vec, threads, vpass) comes from the
// wrapper's plan; taps.kh / taps.kw taps of taps.ky / taps.kx are used.
extern "C" int gk_upfirdn2d(const float* x, float* y, int B, int H, int W,
                            int C, int OH, int OW, int up_x, int up_y,
                            int down_x, int down_y, int pad_x0, int pad_y0,
                            int toh, int tow, int ct, int ih, int iw, int vec,
                            int threads, int vpass, Taps taps, void* stream) {
  return dispatch(x, y, B, H, W, C, OH, OW, up_x, up_y, down_x, down_y, pad_x0,
                  pad_y0, toh, tow, ct, ih, iw, vec, threads, vpass, taps,
                  stream);
}

// The bf16 instance: x and y bf16, the same plan and taps.
extern "C" int gk_upfirdn2d_bf16(const void* x, void* y, int B, int H, int W,
                                 int C, int OH, int OW, int up_x, int up_y,
                                 int down_x, int down_y, int pad_x0, int pad_y0,
                                 int toh, int tow, int ct, int ih, int iw,
                                 int vec, int threads, int vpass, Taps taps,
                                 void* stream) {
  return dispatch(static_cast<const bf16*>(x), static_cast<bf16*>(y), B, H, W,
                  C, OH, OW, up_x, up_y, down_x, down_y, pad_x0, pad_y0, toh,
                  tow, ct, ih, iw, vec, threads, vpass, taps, stream);
}
