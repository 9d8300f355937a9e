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
// bfloat16 images (the _bf16 entries): alpha and the intercepts stay
// float32, every tap is converted to fp32, the geometry and the lerp (and the
// adjoint's sums) run in fp32 with the same _rn steps, and each result is
// rounded once to bf16 on the store. Each direction is a kernel of its own,
// resample_rows_bf16_kernel and resample_rows_t_bf16_kernel (the float32
// kernels above stay float32 only):
//
// Why. At ADA's draws the intercept climbs about half a source row per
// column (rotations and shears), so the 32 columns of a warp read about 16
// to 19 distinct rows. The thread-per-output design above then makes each
// warp load touch as many 128-byte lines as rows: the float32 instance and
// the bf16 one take the same time (L1 lines, not bytes, bound them), and
// the bf16 one reaches a third of its bytes bound. A run of 8 columns shares
// its source row in about 10% of runs at both pass shapes, so vector loads
// of shared rows would rarely apply.
//
// Design. A block takes a tile of 32 output rows x 32 columns and 128
// threads, each 8 consecutive columns of one output row:
//   1. every thread computes its columns' geometry (geometry(), the same _rn
//      steps, so the coefficients are bit for bit the forward's and the
//      adjoint's), and the block reduces the lowest and highest source row
//      any output of the tile reads: the tile's band (about 32*|alpha| + 32
//      * the intercept's slope + 2 rows, 43 to 57 on average at ADA's draws);
//   2. it stages the band's rows of all C channels and its 32 columns in
//      shared memory with 16-byte cp.async copies (8 bytes where W % 8 != 0
//      but W % 4 == 0; 2-byte loads otherwise), zero past the last column
//      and in the rows outside the image, so the lerp reads every tap from
//      the band without a bounds test;
//   3. each thread lerps its outputs from shared memory (the geometry again:
//      cheaper than holding it in registers across the staging) and stores
//      each channel's 8 outputs as one 16-byte store (two 8-byte stores
//      where W % 8 != 0; one at a time at the ragged right end).
// A band taller than the shared buffer (BAND_SMEM bytes; a steep or scaled
// draw, or many channels) falls back to reading the taps from global memory,
// tile by tile, with the same arithmetic. 32-row tiles of 128 threads, and
// not 64-row tiles of 256: their bands fetch more rows than they use, but on
// the H100 they ran no slower at pass V and faster at pass H, more blocks an
// SM overlapping one block's staging with another's lerps.
//
// The bf16 adjoint stages a band too. Its thread-per-(b, s, w) form above
// walks one candidate window per thread, and the 32 windows of a warp start
// at about 16 different cotangent rows, so each 2-byte warp load touched
// as many lines as rows and the kernel ran no faster than its float32
// instance. A block takes a tile of BT_ROWS = 32 source rows x 32 columns
// and 128 threads, each 8 consecutive rows of one column (a warp: 32
// columns):
//   1. every thread computes the candidate rows of its run of rows
//      (walk_range(): the union of their windows, the same rounded 1/alpha
//      and widening), and the block reduces the lowest and highest
//      cotangent row of any non-empty walk: the tile's band (about 32 and
//      34 rows on average at ADA's passes V and H, as chip_smoke.py's phase
//      16 (a) counts them from the draw's geometry; every tile staged);
//   2. it stages the band's rows of all C channels and the tile's columns
//      with cp.async as the forward does (16, 8 or 2 bytes), zero past W;
//   3. each thread walks its v once, in increasing v, with geometry() once
//      a v, and adds coef_t * g[v] (tap_coef()'s three coefficients, the
//      zero one too) to the running sums of rows k0(v) + t, t = 0, 1, 2:
//      three slots that slide with k0, which is monotone in v (up for
//      alpha >= 0, down for alpha < 0); a row is done when k0 has moved
//      past it, and is rounded into the tile's output in shared memory;
//      BT_CH channels a walk (ADA's images), fewer in a last group;
//   4. the tile's rows leave as 16-byte stores (8-byte where W % 8 != 0,
//      one element at a time at the ragged right end).
// A first design gave each thread 8 columns of one row, as the forward
// does, and walked each output's own window: ~6 geometry() calls an output
// against ~1.4 here, and it ran at 20% of the bytes bound on the H100.
// Tiles of 16 and 64 rows ran slower than 32 at both pass shapes there.
// Each row's sum has the thread-per-output kernel's terms in its order
// (increasing v; every v of a row's window whose taps reach it lies in the
// walk), so the bits are that kernel's. A band over BAND_T_SMEM bytes (a
// small |alpha|, alpha = 0 or a subnormal one, a steep intercept, many
// channels) reads g from global memory with the same arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// the bf16 forward's tile (ops/resample.py::forward_plan mirrors them)
constexpr int BF_TW = 32;               // output columns a block
constexpr int BF_TV = 32;               // output rows a block
constexpr int BF_NW = 8;                // consecutive columns a thread
constexpr int BAND_SMEM = BF_TV * 512;  // the staged band's bytes (16 KB)
// the bf16 adjoint's tile (ops/resample.py::adjoint_plan mirrors them):
// BF_TW source columns by BT_ROWS source rows of BT_THREADS threads, BT_CH
// channels a walk of v, and its staged band's bytes (4 cotangent rows of 3
// channels a tile row)
constexpr int BT_ROWS = 32;
constexpr int BT_THREADS = 128;
constexpr int BT_CH = 3;
constexpr int BAND_T_SMEM = BT_ROWS * 768;

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

// The candidate rows [v0, v1] of the cotangent whose taps may reach any
// source row of s_first..s_last in a column at intercept icpt (see the
// header; for one row, its window): the ends are monotone in s. Empty where
// v0 > v1. full: alpha = 0, or 1/alpha (inv) overflows (a subnormal alpha).
__device__ __forceinline__ void walk_range(float inv, bool full, float icpt,
                                           int s_first, int s_last, int V,
                                           int& v0, int& v1) {
  v0 = 0, v1 = V - 1;
  if (full) return;
  const float U = floorf(icpt);
  const float e0 = __fmul_rn(__fsub_rn((float)(s_first - 2), U), inv);
  const float e1 = __fmul_rn(__fsub_rn((float)(s_last + 1), U), inv);
  // clip in float first: the ends may be huge or infinite
  const float lo = fminf(fmaxf(fminf(e0, e1), -2.f), (float)V + 1.f);
  const float hi = fminf(fmaxf(fmaxf(e0, e1), -2.f), (float)V + 1.f);
  v0 = max(v0, (int)floorf(lo) - 1);
  v1 = min(v1, (int)ceilf(hi) + 1);
}

// The coefficient of tap t = s - k0(v) in output v's lerp, or false where
// source row s is none of v's taps.
__device__ __forceinline__ bool tap_coef(const Geometry& g, int s, float& coef) {
  const int t = s - g.k0;
  if (t < 0 || t > 2) return false;
  const float one_f = __fsub_rn(1.f, g.f);
  coef = t == 0 ? (g.e1 ? 0.f : one_f) : t == 1 ? (g.e1 ? one_f : g.f) : (g.e1 ? g.f : 0.f);
  return true;
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
  // 1/alpha overflows for a subnormal alpha: take all of [0, V) there too
  const float inv = __frcp_rn(a);
  int v0, v1;
  walk_range(inv, !(a != 0.f && isfinite(inv)), ic, s, s, V, v0, v1);
  // the geometry is the same for every channel: CMAX channels per walk
  for (int c0 = 0; c0 < C; c0 += CMAX) {
    const T* gp = gout + ((int64_t)b * C + c0) * V * W + w;
    float acc[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
    for (int v = v0; v <= v1; ++v) {
      float coef;
      if (!tap_coef(geometry(a, ic, v), s, coef)) continue;
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

// The bf16 forward (see the header). A: the elements of one aligned access
// of a row (8, 4 or 1: W % 8 == 0, W % 4 == 0, else).
template <int A>
__global__ void __launch_bounds__(BF_TW / BF_NW * BF_TV, 6)
    resample_rows_bf16_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ alpha,
                              const float* __restrict__ icpt,
                              bf16* __restrict__ out, int C, int S, int W,
                              int V) {
  extern __shared__ __align__(16) unsigned char band_raw[];
  bf16* band = reinterpret_cast<bf16*>(band_raw);
  __shared__ int red[2][BF_TW / BF_NW * BF_TV / 32];
  const int run = threadIdx.x % (BF_TW / BF_NW);
  const int v = blockIdx.y * BF_TV + threadIdx.x / (BF_TW / BF_NW);
  const int tw0 = blockIdx.x * BF_TW;
  const int w0 = tw0 + run * BF_NW;
  const int b = blockIdx.z;
  const float a = alpha[b];
  const float* ic = icpt + (int64_t)b * W;

  // 1. the geometry of the thread's columns, and the tile's band
  auto load_icpt = [&](float (&ic8)[BF_NW]) {
    if (A >= 4 && w0 + BF_NW <= W) {
      const float4 p = *reinterpret_cast<const float4*>(ic + w0);
      const float4 q = *reinterpret_cast<const float4*>(ic + w0 + 4);
      ic8[0] = p.x, ic8[1] = p.y, ic8[2] = p.z, ic8[3] = p.w;
      ic8[4] = q.x, ic8[5] = q.y, ic8[6] = q.z, ic8[7] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < BF_NW; ++k) ic8[k] = w0 + k < W ? ic[w0 + k] : 0.f;
    }
  };
  float ic8[BF_NW];
  load_icpt(ic8);
  const bool v_ok = v < V;
  int lo_row = INT_MAX, hi_row = INT_MIN;
#pragma unroll
  for (int k = 0; k < BF_NW; ++k) {
    const Geometry g = geometry(a, ic8[k], v);
    const int kl = g.k0 + (g.e1 ? 1 : 0);
    if (v_ok && w0 + k < W) {
      lo_row = min(lo_row, kl);
      hi_row = max(hi_row, kl + 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_row = min(lo_row, __shfl_xor_sync(0xffffffffu, lo_row, o));
    hi_row = max(hi_row, __shfl_xor_sync(0xffffffffu, hi_row, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[0][warp] = lo_row, red[1][warp] = hi_row;
  __syncthreads();
  lo_row = red[0][0], hi_row = red[1][0];
#pragma unroll
  for (int i = 1; i < BF_TW / BF_NW * BF_TV / 32; ++i)
    lo_row = min(lo_row, red[0][i]), hi_row = max(hi_row, red[1][i]);
  // the band's rows, zero where they lie outside the image (so the lerp
  // reads every tap from the band unchecked)
  const int r0 = lo_row;
  const int64_t rows64 = (int64_t)hi_row - lo_row + 1;
  const bool staged = C * rows64 * BF_TW * 2 <= BAND_SMEM;
  const int rows = staged ? (int)rows64 : 0;
  const int64_t plane = (int64_t)S * W;

  // 2. stage the band: rows r0..hi_row x the tile's 32 columns, every channel
  if (staged) {
    // thread t copies chunk t % PER_ROW of rows t / PER_ROW, + 256 / PER_ROW, ...
    constexpr int PER_ROW = BF_TW / A;
    constexpr int ROW_STEP = BF_TW / BF_NW * BF_TV / PER_ROW;
    const int chunk = threadIdx.x % PER_ROW;
    const int col = tw0 + chunk * A;
    for (int c = 0; c < C; ++c) {
      const bf16* img = x + ((int64_t)b * C + c) * plane + col;
      bf16* dst_c = band + c * rows * BF_TW + chunk * A;
      for (int r = threadIdx.x / PER_ROW; r < rows; r += ROW_STEP) {
        const bool in_img = col < W && r0 + r >= 0 && r0 + r < S;
        const bf16* src = img + (int64_t)(r0 + r) * W;
        bf16* dst = dst_c + r * BF_TW;
        if constexpr (A == 1) {
          *dst = in_img ? *src : __ushort_as_bfloat16(0);
        } else {
          const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
          const bf16* s_ = in_img ? src : x;
          if constexpr (A == 8)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                         "l"(s_), "r"(in_img ? 16 : 0));
          else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                         "l"(s_), "r"(in_img ? 8 : 0));
        }
      }
    }
    if constexpr (A > 1) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
  }
  __syncthreads();
  if (!v_ok || w0 >= W) return;

  // 3. the lerp of each channel's 8 outputs, one store where aligned (the
  // geometry again: recomputing it is cheaper than holding it in registers
  // across the staging, which would cost the SM a block)
  int klo[BF_NW];
  float f[BF_NW], one_f[BF_NW];
  load_icpt(ic8);  // again, from L1: not held across the staging
#pragma unroll
  for (int k = 0; k < BF_NW; ++k) {
    const Geometry g = geometry(a, ic8[k], v);
    klo[k] = g.k0 + (g.e1 ? 1 : 0);
    f[k] = g.f;
    one_f[k] = __fsub_rn(1.f, g.f);
  }
  const bool whole = w0 + BF_NW <= W;
  for (int c = 0; c < C; ++c) {
    float o[BF_NW];
    const bf16* img = x + ((int64_t)b * C + c) * plane;
    const bf16* rowc = band + c * rows * BF_TW + (w0 - tw0);
#pragma unroll
    for (int k = 0; k < BF_NW; ++k) {
      const int kl = klo[k];
      float lo = 0.f, hi = 0.f;
      if (w0 + k < W) {  // (a column past W has no band row)
        if (staged) {
          lo = __bfloat162float(rowc[(kl - r0) * BF_TW + k]);
          hi = __bfloat162float(rowc[(kl + 1 - r0) * BF_TW + k]);
        } else {
          if (kl >= 0 && kl < S) lo = ld(img + (int64_t)kl * W + w0 + k);
          if (kl + 1 >= 0 && kl + 1 < S) hi = ld(img + (int64_t)(kl + 1) * W + w0 + k);
        }
      }
      o[k] = __fadd_rn(__fmul_rn(one_f[k], lo), __fmul_rn(f[k], hi));
    }
    bf16* dst = out + (((int64_t)b * C + c) * V + v) * W + w0;
    if (A > 1 && whole) {
      uint32_t u[BF_NW / 2];
#pragma unroll
      for (int k = 0; k < BF_NW / 2; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
        u[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      if constexpr (A == 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
      } else {
        reinterpret_cast<uint2*>(dst)[0] = make_uint2(u[0], u[1]);
        reinterpret_cast<uint2*>(dst)[1] = make_uint2(u[2], u[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < BF_NW; ++k)
        if (w0 + k < W) dst[k] = __float2bfloat16_rn(o[k]);
    }
  }
}

// The bf16 adjoint (see the header). A: the elements of one aligned access
// of a row (8, 4 or 1).
template <int A>
__global__ void __launch_bounds__(BT_THREADS)
    resample_rows_t_bf16_kernel(const bf16* __restrict__ gout,
                                const float* __restrict__ alpha,
                                const float* __restrict__ icpt,
                                bf16* __restrict__ dx, int C, int S, int W,
                                int V) {
  constexpr int SR = BT_ROWS, CG = BT_CH;
  constexpr int R = SR * BF_TW / BT_THREADS;  // rows a thread
  extern __shared__ __align__(16) unsigned char band_raw[];
  bf16* band = reinterpret_cast<bf16*>(band_raw);
  __shared__ __align__(16) bf16 outs[CG][SR][BF_TW];
  __shared__ int red[2][BT_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int tw0 = blockIdx.x * BF_TW;
  const int ts0 = blockIdx.y * SR;
  const int w = tw0 + lane;
  const int s0 = ts0 + (threadIdx.x >> 5) * R;
  const int s_last = min(s0 + R, S) - 1;
  const int b = blockIdx.z;
  const float a = alpha[b];
  const float inv = __frcp_rn(a);
  const bool full = !(a != 0.f && isfinite(inv));
  const bool live = w < W && s0 < S;
  const float ic = live ? icpt[(int64_t)b * W + w] : 0.f;

  // 1. the thread's walk of v (its rows' windows), and the tile's band:
  // the rows of the cotangent any non-empty walk of the tile reads
  int v0 = 0, v1 = -1;
  if (live) walk_range(inv, full, ic, s0, s_last, V, v0, v1);
  int lo_row = v0 <= v1 ? v0 : INT_MAX, hi_row = v0 <= v1 ? v1 : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_row = min(lo_row, __shfl_xor_sync(0xffffffffu, lo_row, o));
    hi_row = max(hi_row, __shfl_xor_sync(0xffffffffu, hi_row, o));
  }
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[0][warp] = lo_row, red[1][warp] = hi_row;
  __syncthreads();
  lo_row = red[0][0], hi_row = red[1][0];
#pragma unroll
  for (int i = 1; i < BT_THREADS / 32; ++i)
    lo_row = min(lo_row, red[0][i]), hi_row = max(hi_row, red[1][i]);
  const int r0 = lo_row;
  const int64_t rows64 = hi_row >= lo_row ? (int64_t)hi_row - lo_row + 1 : 0;
  const bool staged = C * rows64 * BF_TW * 2 <= BAND_T_SMEM;
  const int rows = staged ? (int)rows64 : 0;

  // 2. stage the band: rows r0..hi_row of every channel, the tile's 32
  // columns, zero past W (and outside [0, V), where no walk reaches)
  if (staged) {
    constexpr int PER_ROW = BF_TW / A;
    constexpr int ROW_STEP = BT_THREADS / PER_ROW;
    const int chunk = threadIdx.x % PER_ROW;
    const int col = tw0 + chunk * A;
    for (int c = 0; c < C; ++c) {
      const bf16* img = gout + ((int64_t)b * C + c) * V * W + col;
      bf16* dst_c = band + c * rows * BF_TW + chunk * A;
      for (int r = threadIdx.x / PER_ROW; r < rows; r += ROW_STEP) {
        const bool in_img = col < W && r0 + r >= 0 && r0 + r < V;
        const bf16* src = img + (int64_t)(r0 + r) * W;
        bf16* dst = dst_c + r * BF_TW;
        if constexpr (A == 1) {
          *dst = in_img ? *src : __ushort_as_bfloat16(0);
        } else {
          const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
          const bf16* s_ = in_img ? src : gout;
          if constexpr (A == 8)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                         "l"(s_), "r"(in_img ? 16 : 0));
          else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                         "l"(s_), "r"(in_img ? 8 : 0));
        }
      }
    }
    if constexpr (A > 1) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
  }
  __syncthreads();

  // 3. per CG channels: each thread walks its v once, in increasing v,
  // adding coef_t * g[v] to the running sums of rows k0(v) + t, t = 0, 1,
  // 2 (three slots that slide with k0, monotone in v: up for alpha >= 0,
  // down for alpha < 0); a row is done, and rounded into the tile's
  // output in shared memory, when k0 moves past it. Then the tile's rows
  // leave in 16-byte stores (8-byte where W % 8 != 0, one element at a
  // time at the ragged right end).
  const bool up = !(a < 0.f);
  const int64_t plane = (int64_t)V * W;
  for (int c0 = 0; c0 < C; c0 += CG) {
    const int cg = min(CG, C - c0);
    if (live) {
      float acc[3][CG];
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[t][c] = 0.f;
      // the row of slot 0; slot t holds row base + t (up) or base - t
      int base = up ? s0 - 2 : s_last + 2;
      auto emit = [&]() {  // slot 0's row is done: round it, slide
        if (base >= s0 && base <= s_last) {
#pragma unroll
          for (int c = 0; c < CG; ++c)
            if (c < cg) outs[c][base - ts0][lane] = __float2bfloat16_rn(acc[0][c]);
        }
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          acc[0][c] = acc[1][c], acc[1][c] = acc[2][c], acc[2][c] = 0.f;
        }
        base += up ? 1 : -1;
      };
      for (int v = v0; v <= v1; ++v) {
        const Geometry g = geometry(a, ic, v);
        const int k = g.k0;
        if (up) {
          if (k + 2 < s0) continue;
          if (k > s_last) break;
          while (base < k) emit();
        } else {
          if (k > s_last) continue;
          if (k + 2 < s0) break;
          while (base > k + 2) emit();
        }
        const float one_f = __fsub_rn(1.f, g.f);
        // tap t's coefficient (tap_coef), t = 0, 1, 2, and the slot of
        // row k + t: t (up) or 2 - t (down)
        const float c0f = g.e1 ? 0.f : one_f, c1f = g.e1 ? one_f : g.f, c2f = g.e1 ? g.f : 0.f;
        const float cs[3] = {up ? c0f : c2f, c1f, up ? c2f : c0f};
        float gv[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          gv[c] = 0.f;
          if (c < cg)
            gv[c] = staged ? __bfloat162float(band[((c0 + c) * rows + v - r0) * BF_TW + lane])
                           : ld(gout + ((int64_t)b * C + c0 + c) * plane + (int64_t)v * W + w);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int c = 0; c < CG; ++c)
            acc[j][c] = __fadd_rn(acc[j][c], __fmul_rn(cs[j], gv[c]));
      }
      if (up) {
        while (base <= s_last) emit();
      } else {
        while (base >= s0) emit();
      }
    }
    __syncthreads();
    constexpr int PER_ROW = BF_TW / A;
    for (int i = threadIdx.x; i < cg * SR * PER_ROW; i += BT_THREADS) {
      const int chunk = i % PER_ROW, r = i / PER_ROW % SR, c = i / (PER_ROW * SR);
      const int s = ts0 + r, col = tw0 + chunk * A;
      if (s >= S || col >= W) continue;
      bf16* dst = dx + (((int64_t)b * C + c0 + c) * S + s) * W + col;
      const bf16* src = &outs[c][r][chunk * A];
      if constexpr (A == 8) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else if constexpr (A == 4) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      } else {
        *dst = *src;
      }
    }
    __syncthreads();
  }
}

template <int A>
cudaError_t launch_adj_bf16_kernel(const bf16* gout, const float* alpha,
                                   const float* icpt, bf16* dx, int B, int C,
                                   int S, int W, int V, cudaStream_t s) {
  static const cudaError_t set = cudaFuncSetAttribute(
      resample_rows_t_bf16_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BAND_T_SMEM);
  if (set != cudaSuccess) return set;
  const dim3 grid((W + BF_TW - 1) / BF_TW, (S + BT_ROWS - 1) / BT_ROWS, B);
  resample_rows_t_bf16_kernel<A><<<grid, BT_THREADS, BAND_T_SMEM, s>>>(
      gout, alpha, icpt, dx, C, S, W, V);
  return cudaSuccess;
}

int launch_adj_bf16(const bf16* gout, const float* alpha, const float* icpt,
                    bf16* dx, int B, int C, int S, int W, int V, int tw, int ts,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tw != BF_TW || ts != BT_ROWS) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      W % 8 == 0   ? launch_adj_bf16_kernel<8>(gout, alpha, icpt, dx, B, C, S, W, V, s)
      : W % 4 == 0 ? launch_adj_bf16_kernel<4>(gout, alpha, icpt, dx, B, C, S, W, V, s)
                   : launch_adj_bf16_kernel<1>(gout, alpha, icpt, dx, B, C, S, W, V, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int launch_fwd_bf16(const bf16* x, const float* alpha, const float* icpt,
                    bf16* out, int B, int C, int S, int W, int V, int tw,
                    int tv, void* stream) {
  if (tw != BF_TW || tv != BF_TV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + BF_TW - 1) / BF_TW, (V + BF_TV - 1) / BF_TV, B);
  const int threads = BF_TW / BF_NW * BF_TV;
  if (W % 8 == 0)
    resample_rows_bf16_kernel<8><<<grid, threads, BAND_SMEM, s>>>(x, alpha, icpt, out, C, S, W, V);
  else if (W % 4 == 0)
    resample_rows_bf16_kernel<4><<<grid, threads, BAND_SMEM, s>>>(x, alpha, icpt, out, C, S, W, V);
  else
    resample_rows_bf16_kernel<1><<<grid, threads, BAND_SMEM, s>>>(x, alpha, icpt, out, C, S, W, V);
  return (int)cudaGetLastError();
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
// The bf16 forward's (tw, tv) is its tile, (BF_TW, BF_TV); its grid
// (ceil(W / tw), ceil(V / tv), B) of 256 threads.
extern "C" int gk_resample_rows_bf16(const void* x, const float* alpha,
                                     const float* icpt, void* out, int B,
                                     int C, int S, int W, int V, int tw,
                                     int tv, void* stream) {
  return launch_fwd_bf16(static_cast<const bf16*>(x), alpha, icpt,
                         static_cast<bf16*>(out), B, C, S, W, V, tw, tv, stream);
}

// The bf16 adjoint's (tw, ts) is its tile, BF_TW columns by BT_ROWS source
// rows (ops/resample.py::adjoint_plan); its grid (ceil(W / tw), ceil(S /
// ts), B) of BT_THREADS threads.
extern "C" int gk_resample_rows_t_bf16(const void* gout, const float* alpha,
                                       const float* icpt, void* dx, int B,
                                       int C, int S, int W, int V, int tw,
                                       int ts, void* stream) {
  return launch_adj_bf16(static_cast<const bf16*>(gout), alpha, icpt,
                         static_cast<bf16*>(dx), B, C, S, W, V, tw, ts, stream);
}
