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
// bfloat16 (gk_upfirdn2d_bf16): a kernel of its own, upfirdn2d_bf16_kernel,
// with a plan of its own (ops/upfirdn2d.py::plan at a 2-byte element). The
// bytes halve, so the float32 design's staging and shared-memory traffic,
// which that instance hides at 4 bytes an element, bound it. So:
//   1. the footprint is staged as bf16: cp.async with a zero-fill source
//      size, 16 bytes (8 channels) a copy where C % 8 == 0, 8 bytes where
//      C % 4 == 0 (ADA's y passes as 4-channel columns), and 2-byte loads,
//      four in flight a thread, otherwise (C = 3). cp.async and not TMA:
//      the tile's footprint starts at any pixel, the pad and the crop move
//      it by a sample, and the 4-channel view's rows are not 16-byte
//      multiples, where one cp.async a thread needs no tensor map per
//      shape and stride and no barrier;
//   2. the vertical pass converts to fp32 and writes the fp32 intermediate
//      as the float32 kernel does, RV output rows a thread, so each staged
//      row it reads serves every one of them (RV + kh - 1 reads for RV rows
//      at up = down = 1, not RV * kh);
//   3. the horizontal pass computes CH consecutive output columns a thread
//      from one sweep over the intermediate (CH + kw - 1 reads, not CH *
//      kw) and stores each output's VEC channels at once: 16 bytes where C
//      % 8 == 0. Each output is rounded once, to nearest even, on the store.
// Both passes sum their taps in increasing order as the float32 kernel
// does, so the fp32 sums before the rounding are that kernel's. The 8-
// channel fp32 intermediate is written and read as two float4 halves, the
// order of the two chosen per quarter-warp so that its eight 16-byte
// accesses fall in eight distinct bank groups (by selects: a register
// array indexed at run time would live in local memory). At 2 bytes an
// element, instructions and shared-memory accesses, not bytes, set the
// pace, so the discriminator's 4 x 4 blur (up = down = 1, 8 channels a
// thread) is instantiated with its taps known: the passes unrolled, the
// weights in registers, no per-tap tests, RV_BLUR rows a thread. Blocks
// are small (ops/upfirdn2d.py::_plan_bf16), so an SM holds several whose
// staging and passes overlap.
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

// one staging copy of VEC channels into shared memory
template <int VEC>
__device__ __forceinline__ void stage_copy(float* dst, const float* src, bool ok) {
  Vec<VEC>::copy(smem_addr(dst), src, ok);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
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

template <int UX, int DX, int UY, int DY, int VEC>
int launch(const float* x, float* y, int B, const Params& p, int threads,
           cudaStream_t s) {
  auto kernel = upfirdn2d_kernel<UX, DX, UY, DY, VEC, float>;
  const int smem = (p.ih * p.iw + (p.vpass ? p.toh * p.iw : 0)) * p.ct * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.OW + p.tow - 1) / p.tow, (p.OH + p.toh - 1) / p.toh,
            B * p.slices);
  kernel<<<grid, threads, smem, s>>>(x, y, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bf16 kernel
// ---------------------------------------------------------------------------

constexpr int RV = 2;  // output rows a thread in the vertical pass
constexpr int RV_BLUR = 4;  // ... at the known 4 x 4 blur (its taps in registers)
constexpr int CH = 4;  // output columns a thread in the horizontal pass

// VEC bf16 as one access: 16, 8 or 2 bytes
template <int VEC>
struct Bits;
template <>
struct Bits<8> {
  using T = uint4;
};
template <>
struct Bits<4> {
  using T = uint2;
};
template <>
struct Bits<1> {
  using T = unsigned short;
};

// VEC bf16 from shared memory, as fp32
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    const typename Bits<VEC>::T raw = *reinterpret_cast<const typename Bits<VEC>::T*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC fp32 from the intermediate; 8 as two float4 halves, the first one
// `half` (see the header)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC], int half) {
  if constexpr (VEC == 1) {
    v[0] = *p;
  } else if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {  // (selects, not v[4 * half]: a register array takes no runtime index)
    const float4 a = *reinterpret_cast<const float4*>(p + 4 * half);
    const float4 b = *reinterpret_cast<const float4*>(p + 4 * (half ^ 1));
    const float4 lo = half ? b : a, hi = half ? a : b;
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC], int half) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const float4 lo = make_float4(v[0], v[1], v[2], v[3]);
    const float4 hi = make_float4(v[4], v[5], v[6], v[7]);
    *reinterpret_cast<float4*>(p + 4 * half) = half ? hi : lo;
    *reinterpret_cast<float4*>(p + 4 * (half ^ 1)) = half ? lo : hi;
  }
}

// VEC outputs rounded once to bf16, one store
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    typename Bits<VEC>::T raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<typename Bits<VEC>::T*>(p) = raw;
  }
}

// One output tile of the bf16 kernel: its image, channel, first output row
// and column, and the first staged input row and column with the parities
// of their U indices at up = 2.
struct Tile {
  int b, c, oy0, ox0, ey, ex, iy0, ix0;
  bool c_ok;
};

// The horizontal pass over `src` (the fp32 intermediate, or the staged bf16
// rows where the single vertical tap was folded into kx): CH output columns
// a thread. KW > 0 (at up = down = 1 on x): KW taps known, the loops
// unrolled, each tap's weight in a register.
template <int UX, int DX, int VEC, int KW, class S>
__device__ __forceinline__ void hpass_bf16(const S* src, bf16* __restrict__ y,
                                           const Params& p, const Tile& q,
                                           int pos, int np, int cv, int half) {
  static_assert(KW == 0 || (UX == 1 && DX == 1), "known taps at up = down = 1");
  const int pitch = p.iw * p.ct;
  const float* kx = p.taps.kx;
  const int kw = KW ? KW : p.taps.kw;
  float kxr[KW ? KW : 1];
#pragma unroll
  for (int t = 0; t < KW; ++t) kxr[t] = kx[KW - 1 - t];
  const int groups = (p.tow + CH - 1) / CH;
  for (Walk s(pos, groups); s.r < p.toh; s.step(np, groups)) {
    const int oy = q.oy0 + s.r, col0 = s.col * CH, ox = q.ox0 + col0;
    if (oy >= p.OH) break;
    if (ox >= p.OW) continue;
    float acc[CH][VEC];
#pragma unroll
    for (int k = 0; k < CH; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    const S* row = src + s.r * pitch + cv * VEC;
    auto load = [&](int j, float (&v)[VEC]) {
      if constexpr (sizeof(S) == 4)
        load_vec<VEC>(reinterpret_cast<const float*>(row) + j * p.ct, v, half);
      else
        load_vec<VEC>(reinterpret_cast<const bf16*>(row) + j * p.ct, v);
    };
    if constexpr (KW > 0) {
      // columns col0 .. col0 + CH + KW - 2, tap t = jj - k of column k
#pragma unroll
      for (int jj = 0; jj < CH + KW - 1; ++jj) {
        if (col0 + jj >= p.iw) break;
        float v[VEC];
        load(col0 + jj, v);
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          if (jj - k >= 0 && jj - k < KW) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(kxr[jj - k], v[e], acc[k][e]);
          }
        }
      }
    } else {
      // the staged columns j whose taps t = UX*j + ex - col*DX reach one of
      // the CH columns, each read once, in increasing j (so increasing t)
      const int j0 = (col0 * DX - q.ex + UX - 1) / UX;
      const int j1 = min(p.iw - 1, ((col0 + CH - 1) * DX + kw - 1 - q.ex) / UX);
      for (int j = j0; j <= j1; ++j) {
        float v[VEC];
        load(j, v);
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int t = UX * j + q.ex - (col0 + k) * DX;
          if (t >= 0 && t < kw) {
            const float w = kx[kw - 1 - t];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(w, v[e], acc[k][e]);
          }
        }
      }
    }
    bf16* out = y + ((q.b * p.OH + oy) * p.OW + ox) * p.C + q.c;
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (col0 + k < p.tow && ox + k < p.OW) store_vec<VEC>(out + k * p.C, acc[k]);
  }
}

// The vertical pass: toh rows x iw columns of the staged bf16 rows into the
// fp32 intermediate, RV rows a thread. KH > 0 (at up = down = 1 on y): KH
// taps known, unrolled as in hpass_bf16, RV_BLUR rows a thread.
template <int UY, int DY, int VEC, int KH>
__device__ __forceinline__ void vpass_bf16(const bf16* in, float* mid, const Params& p,
                                           const Tile& q, int pos, int np, int cv,
                                           int half) {
  static_assert(KH == 0 || (UY == 1 && DY == 1), "known taps at up = down = 1");
  const int pitch = p.iw * p.ct;
  const float* ky = p.taps.ky;
  const int kh = KH ? KH : p.taps.kh;
  float kyr[KH ? KH : 1];
#pragma unroll
  for (int t = 0; t < KH; ++t) kyr[t] = ky[KH - 1 - t];
  constexpr int R = KH ? RV_BLUR : RV;
  const int groups = (p.toh + R - 1) / R;
  for (Walk s(pos, p.iw); s.r < groups; s.step(np, p.iw)) {
    const int r0 = s.r * R;
    float acc[R][VEC];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    const bf16* col = in + s.col * p.ct + cv * VEC;
    if constexpr (KH > 0) {
      // rows r0 .. r0 + R + KH - 2, tap t = ii - k of row r0 + k
#pragma unroll
      for (int ii = 0; ii < R + KH - 1; ++ii) {
        if (r0 + ii >= p.ih) break;
        float v[VEC];
        load_vec<VEC>(col + (r0 + ii) * pitch, v);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (ii - k >= 0 && ii - k < KH) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(kyr[ii - k], v[e], acc[k][e]);
          }
        }
      }
    } else {
      // staged rows i whose taps t = UY*i + ey - r*DY reach a row of the
      // group, in increasing i (so increasing t)
      const int i0 = (r0 * DY - q.ey + UY - 1) / UY;
      const int i1 = min(p.ih - 1, ((r0 + R - 1) * DY + kh - 1 - q.ey) / UY);
      for (int i = i0; i <= i1; ++i) {
        float v[VEC];
        load_vec<VEC>(col + i * pitch, v);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int t = UY * i + q.ey - (r0 + k) * DY;
          if (t >= 0 && t < kh) {
            const float w = ky[kh - 1 - t];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(w, v[e], acc[k][e]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < p.toh)
        store_vec<VEC>(mid + (r0 + k) * pitch + s.col * p.ct + cv * VEC, acc[k], half);
  }
}

// Stage the tile's input footprint as bf16 (zero outside the image): cp.async
// for 8 or 4 channels a thread, else 2-byte loads, four in flight.
template <int VEC>
__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ x, bf16* in,
                                           const Params& p, const Tile& q,
                                           int pos, int np, int cv) {
  const int pitch = p.iw * p.ct;
  const bf16* xb = x + q.b * p.H * p.W * p.C + q.c;
  if constexpr (VEC > 1) {
    for (Walk s(pos, p.iw); s.r < p.ih; s.step(np, p.iw)) {
      const int iy = q.iy0 + s.r, ix = q.ix0 + s.col;
      const bool ok = q.c_ok && (unsigned)iy < (unsigned)p.H &&
                      (unsigned)ix < (unsigned)p.W;
      const uint32_t dst = smem_addr(in + s.r * pitch + s.col * p.ct + cv * VEC);
      const bf16* src = ok ? xb + (iy * p.W + ix) * p.C : x;
      if constexpr (VEC == 8)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(src), "r"(ok ? 16 : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                     "l"(src), "r"(ok ? 8 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (Walk s(pos, p.iw); s.r < p.ih;) {
      bf16 v[4];
      int dst[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dst[k] = -1;
        if (s.r < p.ih) {
          const int iy = q.iy0 + s.r, ix = q.ix0 + s.col;
          const bool ok = q.c_ok && (unsigned)iy < (unsigned)p.H &&
                          (unsigned)ix < (unsigned)p.W;
          v[k] = ok ? xb[(iy * p.W + ix) * p.C] : __ushort_as_bfloat16(0);
          dst[k] = s.r * pitch + s.col * p.ct + cv;
          s.step(np, p.iw);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (dst[k] >= 0) in[dst[k]] = v[k];
    }
  }
}

// One block a tile (toh x tow outputs x ct channels), as the float32
// kernel's grid. K > 0: the blur's K x K taps known (up = down = 1).
template <int UX, int DX, int UY, int DY, int VEC, int K>
__global__ void __launch_bounds__(256)
    upfirdn2d_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                          const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ctv = p.ct / VEC;
  const int np = blockDim.x / ctv;  // positions a sweep covers (ctv | threads)
  const int cv = threadIdx.x % ctv, pos = threadIdx.x / ctv;
  const int half = (threadIdx.x >> 2) & 1;
  Tile q;
  q.b = blockIdx.z / p.slices;
  q.c = (blockIdx.z - q.b * p.slices) * p.ct + cv * VEC;
  q.c_ok = q.c < p.C;
  q.oy0 = blockIdx.y * p.toh;
  q.ox0 = blockIdx.x * p.tow;
  const int my0 = q.oy0 * DY - p.pad_y0, mx0 = q.ox0 * DX - p.pad_x0;
  q.ey = UY == 2 ? (my0 & 1) : 0;
  q.ex = UX == 2 ? (mx0 & 1) : 0;
  q.iy0 = UY == 2 ? (my0 + q.ey) >> 1 : my0;
  q.ix0 = UX == 2 ? (mx0 + q.ex) >> 1 : mx0;
  bf16* in = reinterpret_cast<bf16*>(smem_raw);
  float* mid = reinterpret_cast<float*>(smem_raw + ((p.ih * p.iw * p.ct * 2 + 15) & ~15));

  // 1. stage the input footprint as bf16
  stage_bf16<VEC>(x, in, p, q, pos, np, cv);
  __syncthreads();
  // 2. vertical pass into the fp32 intermediate
  if (p.vpass) {
    vpass_bf16<UY, DY, VEC, K>(in, mid, p, q, pos, np, cv, half);
    __syncthreads();
  }
  // 3. horizontal pass to the output
  if (!q.c_ok) return;
  if (p.vpass)
    hpass_bf16<UX, DX, VEC, K>(mid, y, p, q, pos, np, cv, half);
  else
    hpass_bf16<UX, DX, VEC, K>(in, y, p, q, pos, np, cv, half);
}

// the bf16 kernel's shared memory: the staged bf16 footprint, 16-byte
// aligned, then the fp32 intermediate
inline int smem_bf16(const Params& p) {
  return ((p.ih * p.iw * p.ct * 2 + 15) & ~15) +
         (p.vpass ? p.toh * p.iw * p.ct * 4 : 0);
}

template <int UX, int DX, int UY, int DY, int VEC, int K = 0>
int launch(const bf16* x, bf16* y, int B, const Params& p, int threads,
           cudaStream_t s) {
  auto kernel = upfirdn2d_bf16_kernel<UX, DX, UY, DY, VEC, K>;
  const int smem = smem_bf16(p);
  // set once per plan of this instance (the wrapper's host time is the
  // small calls' time)
  static int set_smem = -1;
  if (smem > set_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set_smem = smem;
  }
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

template <int UX, int DX, int UY, int DY>
int by_vec(const float* x, float* y, int B, const Params& p, int vec,
           int threads, cudaStream_t s) {
  return vec == 4 ? launch<UX, DX, UY, DY, 4>(x, y, B, p, threads, s)
                  : launch<UX, DX, UY, DY, 1>(x, y, B, p, threads, s);
}

template <int UX, int DX, int UY, int DY>
int by_vec(const bf16* x, bf16* y, int B, const Params& p, int vec,
           int threads, cudaStream_t s) {
  // the discriminator's blur: 4 x 4 taps, up = down = 1, 8 channels a thread
  if constexpr (UX == 1 && DX == 1 && UY == 1 && DY == 1)
    if (vec == 8 && p.vpass && p.taps.kh == 4 && p.taps.kw == 4)
      return launch<1, 1, 1, 1, 8, 4>(x, y, B, p, threads, s);
  return vec == 8   ? launch<UX, DX, UY, DY, 8>(x, y, B, p, threads, s)
         : vec == 4 ? launch<UX, DX, UY, DY, 4>(x, y, B, p, threads, s)
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
      taps.kw > GK_KMAX || vec < 1 || ct % vec ||
      threads > 256 || threads % (ct / vec) || (OH + toh - 1) / toh > 65535 ||
      B * slices > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{H, W, C, OH, OW, pad_x0, pad_y0, toh, tow, ct, ih, iw, slices,
           vpass, taps};
  if constexpr (sizeof(T) == 2) {
    // the bf16 plan: 8 channels a thread too, whole vectors of C (each
    // copy and store aligned), a footprint that covers the tile's taps, and
    // a block's shared memory (two staged footprints and the intermediate)
    const int need_h = vpass ? (((toh - 1) * down_y + taps.kh) + up_y - 1) / up_y : toh;
    const int need_w = (((tow - 1) * down_x + taps.kw) + up_x - 1) / up_x;
    if ((vec == 8 ? C % 8 != 0 : vec == 4 ? C % 4 != 0 : vec != 1) ||
        ih < need_h || iw < need_w || smem_bf16(p) > 232448)
      return (int)cudaErrorInvalidValue;
  } else if (vec != 1 && vec != 4) {
    return (int)cudaErrorInvalidValue;
  }
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
// The float32 kernel takes vec 4 or 1.
extern "C" int gk_upfirdn2d(const float* x, float* y, int B, int H, int W,
                            int C, int OH, int OW, int up_x, int up_y,
                            int down_x, int down_y, int pad_x0, int pad_y0,
                            int toh, int tow, int ct, int ih, int iw, int vec,
                            int threads, int vpass, Taps taps, void* stream) {
  return dispatch(x, y, B, H, W, C, OH, OW, up_x, up_y, down_x, down_y, pad_x0,
                  pad_y0, toh, tow, ct, ih, iw, vec, threads, vpass, taps,
                  stream);
}

// The bf16 kernel: x and y bf16, its own plan (vec 8, 4 or 1), the same
// taps.
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
