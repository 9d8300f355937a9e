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
// Design of the GEMM: the 3xTF32 TMA + wgmma main loop of tf32x3.cuh
// (plain TF32 would keep about 3 digits over K = 2048 and is not offered),
// laid out as the bf16 body's below: every phase class walks the
// (H + 1) x (W + 1) positions of each image flat, 128 a tile, A by TMA's
// im2col mode with the tap as its offsets, B the tap's slice of the
// weights' TF32 planes (split by the C entry, tf32_split_weight_kernel),
// by 32, 64 or 128 channels (ops/modulated_conv.py tf32_plan). One flat
// grid covers the four classes with the 4-tap tiles first and the 1-tap
// tiles last, so the short tiles fill the SMs the long ones leave idle at
// the end.
//
// The blur kernel is bound by bytes (16 taps per output, reading T once
// from device memory at best): one thread owns a 2 x 2 block of outputs and
// 4 channels, reads the 5 x 5 window of T it needs once, blurs it
// separably and writes the 16 outputs as four 16-byte vectors.
//
// On bfloat16 activations (gk_styled_up_conv3x3_bf16) the phase GEMM runs
// on the TMA + wgmma main loop of bf16_wgmma.cuh (the Pallas kernel's bf16
// instance, modulated_conv_pallas.py:405-436: x * s and W in bf16, fp32
// accumulators), and T stays float32: the blur, noise, bias and activation
// then run on the unrounded sums and the kernel rounds once, on the bf16
// store, as the JAX kernel does with its blur folded into the phase
// filters. A bf16 T would halve T's bytes and add a second rounding.
// Bound: the GEMM's operations, 2 * 9 * Cin * Cout flops an input pixel at
// 989 TFLOP/s (0.21 ms a request of 8 at ffhq-256), and the blur's bytes,
// T read once in float32 and the bf16 output written once at 3.35 TB/s
// (0.22 ms, kernel_ab.py bf16_bounds): the two halves' bounds are alike.
// Design of the GEMM: the phase classes' (H + 1 - py) x (W + 1 - px)
// grids are one more than a power of two wide, so a rectangular box wastes
// up to half a tile a row; TMA's im2col mode instead walks a class's
// positions flat across rows and images, 128 or 256 a tile, with the tap
// as its offsets (up_gemm_bf16_kernel). Requires Cin % 8 == 0 and
// Cout % 8 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float SQRT2 = 1.4142135623730951f;

struct UpArgs {
  const float* demod;  // (B, Cout)
  float* t_out;        // (B, 2H+1, 2W+1, Cout)
  int B, H, W, Cin, Cout;
  int tiles_m, tiles_n, chunks;  // a class's tiles: tiles_m x tiles_n
};

// The float32 body's phase GEMM on tf32x3.cuh, a BM x BN tile, laid out as
// the bf16 body's (up_gemm_bf16_kernel, below): every class walks the
// (H + 1) x (W + 1) positions of each image flat, A by TMA's im2col mode
// from base pixel (x - 1, y - 1) of position (y, x), tap (ty, tx) the
// offsets (1 - tx, 1 - ty); the positions outside the class are computed
// and not stored. Blocks: class 0 (4 taps) first, then classes 1, 2 (2
// taps), 3 (1), so the short tiles fill the SMs the long ones leave idle.
template <int BN>
__global__ void __launch_bounds__(NT, 1)
up_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const UpArgs p) {
  namespace bw = bf16wg;
  using TL = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> ring = ring_setup<BN>(smem_raw);

  const int per_class = p.tiles_m * p.tiles_n;
  const int phase = blockIdx.x / per_class;
  const int local = blockIdx.x - phase * per_class;
  const int m0 = (local / p.tiles_n) * BM;
  const int n0 = (local % p.tiles_n) * BN;
  const int py = phase >> 1, px = phase & 1;
  const int ntx = 2 - px;
  const int ntaps = (2 - py) * ntx;
  const int Hg = p.H + 1, Wg = p.W + 1, HWg = Hg * Wg;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread works
    if constexpr (TL::REBALANCE) bw::setmaxnreg_dec<bw::PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* xs = &xmap;
      const CUtensorMap* ws = &wmap;
      bw::prefetch_map(xs);
      bw::prefetch_map(ws);
      const int n = m0 / HWg, r = m0 - n * HWg;
      const int y = r / Wg, x = r - y * Wg;
      produce<BN>(ring, ntaps, p.chunks,
                  [=](uint32_t a, uint32_t bh, uint32_t bl, uint32_t bar, int tap, int c0) {
                    const int ty = ntx == 2 ? tap >> 1 : tap;
                    const int tx = ntx == 2 ? tap & 1 : 0;
                    const int ky = py ? 1 : 2 * ty, kx = px ? 1 : 2 * tx;
                    bw::tma_im2col_4d(a, xs, bar, c0, x - 1, y - 1, n,
                                      static_cast<uint16_t>(1 - tx),
                                      static_cast<uint16_t>(1 - ty));
                    bw::tma_tile_3d(bh, ws, bar, c0, n0, ky * 3 + kx);
                    bw::tma_tile_3d(bl, ws, bar, c0, n0, 9 + ky * 3 + kx);
                  });
    }
  } else {  // the two consumer warpgroups
    if constexpr (TL::REBALANCE) bw::setmaxnreg_inc<bw::CONSUMER_REGS>();
    const int TH = 2 * p.H + 1, TW = 2 * p.W + 1;
    const int M = p.B * HWg;
    bw::RowInfo* table = ring.table();
    if (threadIdx.x < BM) {  // tile row r -> T[b, 2y + py, 2x + px], none outside the class
      const int q = m0 + threadIdx.x;
      const int b = q / HWg, rest = q - b * HWg;
      const int y = rest / Wg, x = rest - y * Wg;
      bw::RowInfo ri;
      ri.off = q < M && y < Hg - py && x < Wg - px
                   ? (((int64_t)b * TH + 2 * y + py) * TW + 2 * x + px) * p.Cout
                   : -1;
      ri.b = b;
      ri.nz = 0.f;
      table[threadIdx.x] = ri;
    }
    float acc[1][TL::ACC];
    consume<BN>(acc, ring, ntaps * p.chunks, threadIdx.x >> 7);
    bw::consumers_sync();  // every stage consumed: the ring is free
    float* st = ring.staged();
    bw::stage_acc<BM, BN>(st, acc);
    bw::consumers_sync();
    bw::store_out<BM, BN>(st, table, p.t_out, n0, p.Cout,
                          [&](const bw::RowInfo& ri, int n, float(&v)[4]) {
                            const float4 d = *reinterpret_cast<const float4*>(
                                p.demod + (int64_t)ri.b * p.Cout + n);
                            v[0] *= d.x;
                            v[1] *= d.y;
                            v[2] *= d.z;
                            v[3] *= d.w;
                          });
  }
}

template <int BN>
int launch_up(const float* xm, const float* planes, UpArgs p, cudaStream_t s) {
  using TL = Tile<BN>;
  // base pixels (x - 1, y - 1) of the (H + 1) x (W + 1) positions: the
  // bounding box [-1, dim - 1] on both axes
  const int lower[2] = {-1, -1}, upper[2] = {0, 0};
  CUtensorMap xmap, wmap;
  cudaError_t e = im2col_map(&xmap, xm, p.B, p.H, p.W, p.Cin, lower, upper);
  if (e == cudaSuccess) e = weight_map(&wmap, planes, p.Cin, p.Cout, BN);
  auto kernel = up_gemm_kernel<BN>;
  if (e == cudaSuccess) e = bf16wg::set_smem(kernel, TL::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<4 * p.tiles_m * p.tiles_n, NT, TL::SMEM_BYTES, s>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

struct UpBf16Args {
  const float* demod;  // (B, Cout)
  float* t_out;        // (B, 2H+1, 2W+1, Cout)
  int B, H, W, Cin, Cout;
  int tiles_m, tiles_n, chunks;  // a class's tiles: tiles_m x tiles_n
};

// The bf16 body's phase GEMM on bf16_wgmma.cuh, a BM x BN tile, T in
// float32. Every class walks the same (H + 1) x (W + 1) grid of positions
// per image, flat over (b, y, x) (x fastest): A comes by TMA's im2col mode,
// BM consecutive positions a load, the base pixel of position (y, x)
// being (x - 1, y - 1) and tap (ty, tx) the offsets (1 - tx, 1 - ty), so
// the load reads pixel (x - tx, y - ty), zero outside the image. The
// positions outside the class ((H + 1 - py) x (W + 1 - px)) and past the
// last image are computed and not stored: a column or row of waste, not
// up to half a tile a row as a rectangular box over (W + 1) columns would
// be. Blocks: class 0 (4 taps) first, then classes 1, 2 (2 taps), 3 (1).
template <int BM, int BN>
__global__ void __launch_bounds__(bf16wg::NT, 1)
up_gemm_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const UpBf16Args p) {
  namespace bw = bf16wg;
  using TL = bw::Tile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  const bw::Ring<BM, BN> ring = bw::ring_setup<BM, BN>(smem_raw);

  const int per_class = p.tiles_m * p.tiles_n;
  const int phase = blockIdx.x / per_class;
  const int local = blockIdx.x - phase * per_class;
  const int m0 = (local / p.tiles_n) * BM;
  const int n0 = (local % p.tiles_n) * BN;
  const int py = phase >> 1, px = phase & 1;
  const int ntx = 2 - px;
  const int ntaps = (2 - py) * ntx;
  const int Hg = p.H + 1, Wg = p.W + 1, HWg = Hg * Wg;

  if (threadIdx.x >= bw::CONSUMERS) {  // the producer warpgroup: one thread works
    if constexpr (TL::REBALANCE) bw::setmaxnreg_dec<bw::PRODUCER_REGS>();
    if (threadIdx.x == bw::CONSUMERS) {
      const CUtensorMap* xs = &xmap;
      const CUtensorMap* ws = &wmap;
      bw::prefetch_map(xs);
      bw::prefetch_map(ws);
      const int n = m0 / HWg, r = m0 - n * HWg;
      const int y = r / Wg, x = r - y * Wg;
      bw::produce<BM, BN>(ring, ntaps, p.chunks, TL::STAGE_BYTES,
                      [=](uint32_t a, uint32_t b, uint32_t bar, int tap, int c0) {
                        const int ty = ntx == 2 ? tap >> 1 : tap;
                        const int tx = ntx == 2 ? tap & 1 : 0;
                        const int ky = py ? 1 : 2 * ty, kx = px ? 1 : 2 * tx;
                        bw::tma_im2col_4d(a, xs, bar, c0, x - 1, y - 1, n,
                                          static_cast<uint16_t>(1 - tx),
                                          static_cast<uint16_t>(1 - ty));
                        bw::tma_tile_3d(b, ws, bar, c0, n0, ky * 3 + kx);
                      });
    }
  } else {  // the two consumer warpgroups
    if constexpr (TL::REBALANCE) bw::setmaxnreg_inc<bw::CONSUMER_REGS>();
    const int TH = 2 * p.H + 1, TW = 2 * p.W + 1;
    const int M = p.B * HWg;
    bw::RowInfo* table = ring.table();
    if (threadIdx.x < BM) {  // tile row r -> T[b, 2y + py, 2x + px], none outside the class
      const int q = m0 + threadIdx.x;
      const int b = q / HWg, rest = q - b * HWg;
      const int y = rest / Wg, x = rest - y * Wg;
      bw::RowInfo ri;
      ri.off = q < M && y < Hg - py && x < Wg - px
                   ? (((int64_t)b * TH + 2 * y + py) * TW + 2 * x + px) * p.Cout
                   : -1;
      ri.b = b;
      ri.nz = 0.f;
      table[threadIdx.x] = ri;
    }
    float acc[TL::MI][TL::ACC];
    bw::consume<BM, BN>(acc, ring, ntaps * p.chunks, threadIdx.x >> 7);
    bw::consumers_sync();  // every stage consumed: the ring is free
    float* st = ring.staged();
    bw::stage_acc<BM, BN>(st, acc);
    bw::consumers_sync();
    bw::store_out<BM, BN>(st, table, p.t_out, n0, p.Cout,
                          [&](const bw::RowInfo& ri, int n, float(&v)[4]) {
                            const float4 d = *reinterpret_cast<const float4*>(
                                p.demod + (int64_t)ri.b * p.Cout + n);
                            v[0] *= d.x;
                            v[1] *= d.y;
                            v[2] *= d.z;
                            v[3] *= d.w;
                          });
  }
}

struct BlurTaps {
  float k[4];  // flipped 1-D taps: out[o] = sum_t k[t] * T[o - 1 + t]
};

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <class OutT>
__global__ void up_blur_epilogue_kernel(const float* __restrict__ t_in,  // (B, 2H+1, 2W+1, C)
                                        const float* __restrict__ noise,  // (Nb, 2H, 2W)
                                        int64_t noise_bs,
                                        const float* __restrict__ nw,
                                        const float* __restrict__ bias,
                                        OutT* __restrict__ out,  // (B, 2H, 2W, C)
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
      store4(out + (((int64_t)b * OH + oy) * OW + ox) * C + c, v);
    }
  }
}

template <int BM, int BN>
int launch_up_bf16(const void* xm, const void* w, UpBf16Args p, int stages,
                   cudaStream_t s) {
  using TL = bf16wg::Tile<BM, BN>;
  if (stages != TL::STAGES) return (int)cudaErrorInvalidValue;
  // base pixels (x - 1, y - 1) of the (H + 1) x (W + 1) positions: the
  // bounding box [-1, dim - 1] on both axes
  const int lower[2] = {-1, -1}, upper[2] = {0, 0};
  CUtensorMap xmap, wmap;
  cudaError_t e = bf16wg::im2col_map(&xmap, xm, p.B, p.H, p.W, p.Cin, lower, upper, BM);
  if (e == cudaSuccess) e = bf16wg::weight_map(&wmap, w, p.Cin, p.Cout, BN);
  auto kernel = up_gemm_bf16_kernel<BM, BN>;
  if (e == cudaSuccess) e = bf16wg::set_smem(kernel, TL::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<4 * p.tiles_m * p.tiles_n, bf16wg::NT, TL::SMEM_BYTES, s>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 entry: w as (3, 3, Cin, Cout), split into ``planes`` (2, 9,
// Cout, Cin; the wrapper's scratch) before the GEMM. The plan
// (ops/modulated_conv.py tf32_plan): ``bn`` the GEMM tile's width (32, 64
// or 128), ``stages`` the ring's depth and ``tiles_m`` a class's tiles, all
// checked against the kernel's.
extern "C" int gk_styled_up_conv3x3(const float* xm, const float* w, float* planes,
                                    const float* demod, const float* noise,
                                    long long noise_bs, const float* nw,
                                    const float* bias, float* scratch,
                                    float* out, int B, int H, int W, int Cin,
                                    int Cout, float k0, float k1, float k2,
                                    float k3, int bn, int stages, int tiles_m,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long positions = (long long)B * (H + 1) * (W + 1);
  if (Cin % 4 || Cout % 4 || bn != tile_n(Cout) || tiles_m != (positions + BM - 1) / BM)
    return (int)cudaErrorInvalidValue;
  if (stages != (bn == 32 ? Tile<32>::STAGES : bn == 64 ? Tile<64>::STAGES : Tile<128>::STAGES))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = split_weights(w, planes, Cin, Cout, s);
  if (e != cudaSuccess) return (int)e;
  UpArgs p{demod, scratch, B, H, W, Cin, Cout, tiles_m, (Cout + bn - 1) / bn,
           (Cin + BK - 1) / BK};
  const int rc = bn == 32   ? launch_up<32>(xm, planes, p, s)
                 : bn == 64 ? launch_up<64>(xm, planes, p, s)
                            : launch_up<128>(xm, planes, p, s);
  if (rc != 0) return rc;
  // the blur taps flipped once here: true convolution
  BlurTaps kt = {{k3, k2, k1, k0}};
  const int64_t total = (int64_t)B * H * W * (Cout / 4);
  const int threads = 256;
  up_blur_epilogue_kernel<float><<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, s>>>(scratch, noise, noise_bs, nw, bias,
                                             out, kt, B, H, W, Cout);
  return (int)cudaGetLastError();
}

// The bf16 entry: xm, w and out bf16; demod, noise, nw, bias and the T
// scratch float32. The plan (ops/modulated_conv.py bf16_plan): ``bm`` the
// GEMM tile's rows (128 or 256, the latter at most 128 wide), ``bn`` its
// width (16 to 256), ``stages`` the ring's depth and ``tiles_m`` a class's
// tiles, both checked against the kernel's.
extern "C" int gk_styled_up_conv3x3_bf16(const void* xm, const void* w,
                                         const float* demod, const float* noise,
                                         long long noise_bs, const float* nw,
                                         const float* bias, float* scratch,
                                         void* out, int B, int H, int W,
                                         int Cin, int Cout, float k0, float k1,
                                         float k2, float k3, int bm, int bn,
                                         int stages, int tiles_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long positions = (long long)B * (H + 1) * (W + 1);
  if (Cin % 8 || Cout % 8 || bn != bf16wg::tile_n(Cout) ||
      (bm != 128 && (bm != 256 || bn > 128)) || tiles_m != (positions + bm - 1) / bm)
    return (int)cudaErrorInvalidValue;
  UpBf16Args p{demod, scratch, B, H, W, Cin, Cout, tiles_m, (Cout + bn - 1) / bn,
               (Cin + bf16wg::BK - 1) / bf16wg::BK};
  int rc;
  if (bm == 256) {
    switch (bn) {
      case 16: rc = launch_up_bf16<256, 16>(xm, w, p, stages, s); break;
      case 32: rc = launch_up_bf16<256, 32>(xm, w, p, stages, s); break;
      case 64: rc = launch_up_bf16<256, 64>(xm, w, p, stages, s); break;
      default: rc = launch_up_bf16<256, 128>(xm, w, p, stages, s);
    }
  } else {
    switch (bn) {
      case 16: rc = launch_up_bf16<128, 16>(xm, w, p, stages, s); break;
      case 32: rc = launch_up_bf16<128, 32>(xm, w, p, stages, s); break;
      case 64: rc = launch_up_bf16<128, 64>(xm, w, p, stages, s); break;
      case 128: rc = launch_up_bf16<128, 128>(xm, w, p, stages, s); break;
      default: rc = launch_up_bf16<128, 256>(xm, w, p, stages, s);
    }
  }
  if (rc != 0) return rc;
  BlurTaps kt = {{k3, k2, k1, k0}};
  const int64_t total = (int64_t)B * H * W * (Cout / 4);
  const int threads = 256;
  up_blur_epilogue_kernel<__nv_bfloat16>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
          scratch, noise, noise_bs, nw, bias, static_cast<__nv_bfloat16*>(out),
          kt, B, H, W, Cout);
  return (int)cudaGetLastError();
}
