// One 1-D pass of ADA's separable shear warp, and its exact adjoint, on
// (B, C, S, W) float32: each column w of each (image, channel) plane is
// resampled along S at the source positions alpha[b]*v + intercept[b, w].
//
// Replaces ganecdotes_tpu/ops/affine_warp_pallas.py::resample_rows (the
// pallas_call at affine_warp_pallas.py:234) and ::resample_rows_t (the
// pallas_call at :266). The index algebra is that of the plain pass
// (ops/affine_warp.py::_resample_pass, affine_warp_pallas.py:85-111):
//
//   U = floor(intercept[b, w]), vfrac = intercept - U,
//   q = floor(alpha*v), r = alpha*v - q, e = floor(r + vfrac), f = r + vfrac - e,
//   tap_t = x[b, c, U + q + t, w] for t in {0, 1, 2}, zero where the
//           unwrapped index U + q + t lies outside [0, S-1],
//   out[b, c, v, w] = (1 - f)*lo + f*hi, (lo, hi) = e ? (tap1, tap2) : (tap0, tap1).
//
// The TPU kernel rolls each column by U with log2(S) conditional shifts and
// selects the taps with one-hot matmuls, because the TPU has no cheap
// gather; here one thread per output (b, v, w), w across a warp, v and b on
// the grid's y and z (no integer division), computes geometry() once and
// reads the two live taps of each of the C channels directly. Every float
// step is a separately rounded _rn intrinsic, so nvcc contracts nothing
// into an FMA and the result equals the plain torch pass bit for bit.
//
// Bound: bytes. The forward reads each tap once from L2/L1 (neighbouring
// threads hold neighbouring w, so a warp's loads of one tap row coalesce
// whenever U varies slowly along w) and writes each output once; at ADA's
// 256^2 shape pass V moves 150.5 MB in and 99.6 MB out (74.7 us at 3.35
// TB/s), pass H 99.6 MB in and 65.9 MB out (49.4 us).
//
// The adjoint is a gather: one thread per (b, s, w) of the (B, C, S, W)
// result, w fastest across a warp, writing its C elements exactly once (no
// zero fill, no atomics). dx[s] sums coef_t(v) * g[v] over the v whose taps
// k0(v) + t hit s, t = s - k0(v) in {0, 1, 2}. k0(v) = U + floor(alpha*v)
// is monotone in v (non-decreasing for alpha >= 0, non-increasing for
// alpha < 0), so those v form one contiguous range: the thread takes the
// candidate window [min, max] of (s - 2 - U)/alpha and (s + 1 - U)/alpha
// (times a rounded 1/alpha), widened by one on each side (the rounding of
// alpha*v and of the quotients moves its ends by far less than that) and
// clipped to [0, V), and decides each candidate's membership and
// coefficient with the same geometry() as the forward, so the coefficients
// are bit for bit the forward's. The geometry does not depend on the
// channel, so one walk of v serves up to CMAX channels. alpha = 0 (delta is
// not clamped) and a subnormal alpha, whose 1/alpha overflows, take all of
// [0, V); small |alpha| gives wide windows, right
// but slower. Each sum runs in increasing v, so runs repeat bit for bit. At
// ADA's scales (|alpha| ~ 1) a thread visits about 6 candidates; the pass
// moves the same bytes as the forward.
//
// bfloat16 images (the _bf16 entries): both kernels instantiated on bf16
// storage for the image and its cotangent (alpha and the intercepts stay
// float32). Each tap is converted to fp32 on the load, the geometry, the
// lerp and the adjoint's sums run in fp32 with the same _rn steps, and the
// result is rounded once to bf16 on the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;   // adjoint block: 32 columns w (one warp) ...
constexpr int TS = 8;    // ... by 8 source rows s
constexpr int CMAX = 4;  // channels one adjoint thread sums per walk of v

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Geometry {
  int k0;     // unwrapped index of tap 0
  bool e1;    // carry: taps (1, 2) instead of (0, 1)
  float f;    // fractional weight of the upper tap
};

__device__ __forceinline__ Geometry geometry(float alpha, float icpt, int v) {
  const float U = floorf(icpt);
  const float vfrac = __fsub_rn(icpt, U);
  const float au = __fmul_rn(alpha, (float)v);
  const float q = floorf(au);
  const float r = __fsub_rn(au, q);
  const float e_in = __fadd_rn(r, vfrac);
  const float e = floorf(e_in);
  Geometry g;
  g.k0 = (int)U + (int)q;
  g.e1 = e == 1.f;
  g.f = __fsub_rn(e_in, e);
  return g;
}

// One thread per output (b, v, w): w across a warp in x, v in y, b in z;
// the geometry once, then every channel's two live taps and the lerp.
template <class T>
__global__ void resample_rows_kernel(const T* __restrict__ x,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ icpt,
                                     T* __restrict__ out, int C, int S,
                                     int W, int V) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (w >= W || v >= V) return;
  const Geometry g = geometry(alpha[b], icpt[(int64_t)b * W + w], v);
  // the lerp reads taps (k0, k0 + 1), or (k0 + 1, k0 + 2) with the carry
  const int klo = g.k0 + (g.e1 ? 1 : 0);
  const bool lo_in = klo >= 0 && klo < S;
  const bool hi_in = klo + 1 >= 0 && klo + 1 < S;
  const float one_f = __fsub_rn(1.f, g.f);
  const int64_t src_plane = (int64_t)S * W, out_plane = (int64_t)V * W;
  const T* lo_p = x + (int64_t)b * C * src_plane + (int64_t)klo * W + w;
  T* o = out + (int64_t)b * C * out_plane + (int64_t)v * W + w;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float lo = lo_in ? ld(lo_p + c * src_plane) : 0.f;
    const float hi = hi_in ? ld(lo_p + c * src_plane + W) : 0.f;
    st(o + c * out_plane, __fadd_rn(__fmul_rn(one_f, lo), __fmul_rn(g.f, hi)));
  }
}

template <class T>
__global__ void resample_rows_t_kernel(const T* __restrict__ gout,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ icpt,
                                       T* __restrict__ dx, int C, int S,
                                       int W, int V) {
  const int w = blockIdx.x * TW + threadIdx.x;
  const int s = blockIdx.y * TS + threadIdx.y;
  const int b = blockIdx.z;
  if (w >= W || s >= S) return;
  const float a = alpha[b];
  const float ic = icpt[(int64_t)b * W + w];
  int v0 = 0, v1 = V - 1;
  // 1/alpha overflows for a subnormal alpha: take all of [0, V) there too
  const float inv = __frcp_rn(a);
  if (a != 0.f && isfinite(inv)) {
    const float U = floorf(ic);
    const float e0 = __fmul_rn(__fsub_rn((float)(s - 2), U), inv);
    const float e1 = __fmul_rn(__fsub_rn((float)(s + 1), U), inv);
    // clip in float first: the ends may be huge or infinite
    const float lo = fminf(fmaxf(fminf(e0, e1), -2.f), (float)V + 1.f);
    const float hi = fminf(fmaxf(fmaxf(e0, e1), -2.f), (float)V + 1.f);
    v0 = max(v0, (int)floorf(lo) - 1);
    v1 = min(v1, (int)ceilf(hi) + 1);
  }
  // the geometry is the same for every channel: CMAX channels per walk
  for (int c0 = 0; c0 < C; c0 += CMAX) {
    const T* gp = gout + ((int64_t)b * C + c0) * V * W + w;
    float acc[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
    for (int v = v0; v <= v1; ++v) {
      const Geometry g = geometry(a, ic, v);
      const int t = s - g.k0;
      if (t < 0 || t > 2) continue;
      const float one_f = __fsub_rn(1.f, g.f);
      // coefficient of tap t in the forward lerp
      const float coef = t == 0 ? (g.e1 ? 0.f : one_f)
                       : t == 1 ? (g.e1 ? one_f : g.f)
                                : (g.e1 ? g.f : 0.f);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c0 + c < C)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(coef, ld(gp + ((int64_t)c * V + v) * W)));
      }
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c0 + c < C) st(dx + (((int64_t)b * C + c0 + c) * S + s) * W + w, acc[c]);
    }
  }
}

template <class T>
int launch_fwd(const T* x, const float* alpha, const float* icpt, T* out,
               int B, int C, int S, int W, int V, int tw, int tv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + tw - 1) / tw, (V + tv - 1) / tv, B);
  resample_rows_kernel<T><<<grid, dim3(tw, tv), 0, s>>>(x, alpha, icpt, out,
                                                          C, S, W, V);
  return (int)cudaGetLastError();
}

template <class T>
int launch_adj(const T* gout, const float* alpha, const float* icpt, T* dx,
               int B, int C, int S, int W, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + TW - 1) / TW, (S + TS - 1) / TS, B);
  resample_rows_t_kernel<T><<<grid, dim3(TW, TS), 0, s>>>(gout, alpha, icpt,
                                                          dx, C, S, W, V);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward's block is (tw, tv) threads, its grid (ceil(W / tw),
// ceil(V / tv), B) (ops/resample.py::forward_plan).
extern "C" int gk_resample_rows(const float* x, const float* alpha,
                                const float* icpt, float* out, int B, int C,
                                int S, int W, int V, int tw, int tv,
                                void* stream) {
  return launch_fwd(x, alpha, icpt, out, B, C, S, W, V, tw, tv, stream);
}

extern "C" int gk_resample_rows_t(const float* gout, const float* alpha,
                                  const float* icpt, float* dx, int B, int C,
                                  int S, int W, int V, void* stream) {
  return launch_adj(gout, alpha, icpt, dx, B, C, S, W, V, stream);
}

// The bf16 instances: the image (or its cotangent) and the output bf16,
// alpha and the intercepts float32.
extern "C" int gk_resample_rows_bf16(const void* x, const float* alpha,
                                     const float* icpt, void* out, int B,
                                     int C, int S, int W, int V, int tw,
                                     int tv, void* stream) {
  return launch_fwd(static_cast<const bf16*>(x), alpha, icpt,
                    static_cast<bf16*>(out), B, C, S, W, V, tw, tv, stream);
}

extern "C" int gk_resample_rows_t_bf16(const void* gout, const float* alpha,
                                       const float* icpt, void* dx, int B,
                                       int C, int S, int W, int V,
                                       void* stream) {
  return launch_adj(static_cast<const bf16*>(gout), alpha, icpt,
                    static_cast<bf16*>(dx), B, C, S, W, V, stream);
}
