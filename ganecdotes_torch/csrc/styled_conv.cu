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
// far above the balance point of the tensor cores; in 3xTF32 three
// products a multiply-add at 495 TFLOP/s.
// Design: an implicit GEMM on the 3xTF32 TMA + wgmma main loop of
// tf32x3.cuh, M = output pixels, N = Cout, K = 9 taps x Cin. A tile is
// 128 consecutive output pixels (flat over images, rows and columns: no
// waste at any width) by 32, 64 or 128 channels (ops/modulated_conv.py
// tf32_plan); tap (dy, dx) is TMA's im2col load of those pixels at the
// offsets (dx, dy) from base pixel (x - 1, y - 1), zero outside the image,
// so the 'same' padding never exists in memory. The C entry first splits
// the (3, 3, Cin, Cout) weights into their (2, 9, Cout, Cin) TF32 planes
// (tf32_split_weight_kernel), which TMA then loads. The whole epilogue
// (demod, noise, bias, leaky-ReLU, sqrt(2)) runs on the staged sums before
// the single 16-byte write. Small M (the 4x4 to 16x16 layers at B = 8,
// every early layer at B = 1) leaves most SMs idle while a few blocks walk
// K = 9 * Cin, so the plan may split the 9 taps 3 or 9 ways over
// blockIdx.y: each split writes its raw sums to a scratch tensor and
// styled_conv_epilogue_kernel sums the splits in order, then runs the
// epilogue. Requires Cin % 4 == 0, Cout % 4 == 0 and 16-byte-aligned
// pointers (the wrapper checks).
//
// On bfloat16 activations (gk_styled_conv3x3_bf16) the same function
// runs on the TMA + wgmma main loop of bf16_wgmma.cuh (the Pallas kernel's
// bf16 instance, modulated_conv_pallas.py:166-184: x * s and W in bf16,
// fp32 accumulators, the epilogue in fp32 and one rounding to bf16 on the
// store). Bound: operations, 2 * 9 * Cin * Cout flops a pixel at
// 989 TFLOP/s (0.52 ms of bf16 tensor-core work a request of 8 at
// ffhq-256, kernel_ab.py bf16_bounds). Design: a tile is a TMA box of tw x th x nb pixels (64 x 2 at
// W >= 64, 32 x 4, 16 x 8, or whole images: ops/modulated_conv.py
// pixel_box), 128 or 256 of them, by 16 to 256 output channels; tap
// (dy, dx) loads the same box at (x0 + dx - 1, y0 + dy - 1), whose
// out-of-image part TMA fills with zeros, so the nine taps are nine box
// loads a 64-channel chunk and the 'same' padding never exists in memory
// (the Pallas kernel reads a (th + 2)-row halo slab and slices its taps
// from it; on Hopper TMA's address generation and L2 make the nine loads
// as cheap, and each lands in the swizzled layout wgmma reads). The tap
// splits and styled_conv_epilogue_kernel are the float32 path's. Requires
// Cin % 8 == 0 and Cout % 8 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
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

struct ConvArgs {
  const float* demod;  // (B, Cout)
  const float* noise;  // (Nb, H, W)
  long long noise_bs;  // 0: broadcast over B
  const float* nw;     // scalar
  const float* bias;   // (Cout,)
  float* out;          // (B, H, W, Cout)
  float* part;         // (nsplit, M, Cout) if nsplit > 1
  int nsplit, B, H, W, Cin, Cout;
  int tiles_n, chunks;
};

// The float32 body: the 9-tap implicit GEMM on tf32x3.cuh, a BM x BN tile
// of BM consecutive output pixels (flat over images, rows and columns).
// A comes by TMA's im2col mode: pixel (y, x) of image b is base pixel
// (x - 1, y - 1) of the bounding box [-1, dim - 2], and tap (dy, dx) the
// offsets (dx, dy), so the load reads pixel (x + dx - 1, y + dy - 1), zero
// outside the image (and past the last image). Splits (blockIdx.y) take
// taps 9 z / nsplit .. 9 (z + 1) / nsplit and write raw sums.
template <int BN>
__global__ void __launch_bounds__(NT, 1)
styled_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const ConvArgs p) {
  namespace bw = bf16wg;
  using TL = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN> ring = ring_setup<BN>(smem_raw);

  const int tm = blockIdx.x / p.tiles_n;
  const int n0 = (blockIdx.x - tm * p.tiles_n) * BN;
  const int64_t m0 = (int64_t)tm * BM;
  const int z = blockIdx.y;
  const int t0 = 9 * z / p.nsplit, t1 = 9 * (z + 1) / p.nsplit;
  const int HW = p.H * p.W;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread works
    if constexpr (TL::REBALANCE) bw::setmaxnreg_dec<bw::PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* xs = &xmap;
      const CUtensorMap* ws = &wmap;
      bw::prefetch_map(xs);
      bw::prefetch_map(ws);
      const int n = (int)(m0 / HW), r = (int)(m0 - (int64_t)n * HW);
      const int y = r / p.W, x = r - y * p.W;
      produce<BN>(ring, t1 - t0, p.chunks,
                  [=](uint32_t a, uint32_t bh, uint32_t bl, uint32_t bar, int tap, int c0) {
                    tap += t0;
                    const int dy = tap / 3, dx = tap - 3 * dy;
                    bw::tma_im2col_4d(a, xs, bar, c0, x - 1, y - 1, n,
                                      static_cast<uint16_t>(dx), static_cast<uint16_t>(dy));
                    bw::tma_tile_3d(bh, ws, bar, c0, n0, tap);
                    bw::tma_tile_3d(bl, ws, bar, c0, n0, 9 + tap);
                  });
    }
  } else {  // the two consumer warpgroups
    if constexpr (TL::REBALANCE) bw::setmaxnreg_inc<bw::CONSUMER_REGS>();
    const int64_t M = (int64_t)p.B * HW;
    bw::RowInfo* table = ring.table();
    if (threadIdx.x < BM) {  // tile row r's pixel, while the first stages load
      const int64_t m = m0 + threadIdx.x;
      const int b = (int)(m / HW);
      bw::RowInfo ri;
      ri.off = m < M ? (m + (p.nsplit > 1 ? z * M : 0)) * p.Cout : -1;
      ri.b = b;
      ri.nz = m < M && p.nsplit == 1 ? *p.nw * p.noise[b * p.noise_bs + (m - (int64_t)b * HW)]
                                     : 0.f;
      table[threadIdx.x] = ri;
    }
    float acc[1][TL::ACC];
    consume<BN>(acc, ring, (t1 - t0) * p.chunks, threadIdx.x >> 7);
    bw::consumers_sync();  // every stage consumed: the ring is free
    float* st = ring.staged();
    bw::stage_acc<BM, BN>(st, acc);
    bw::consumers_sync();
    if (p.nsplit > 1) {  // this split's raw sums
      bw::store_out<BM, BN>(st, table, p.part, n0, p.Cout,
                            [](const bw::RowInfo&, int, float(&)[4]) {});
    } else {
      bw::store_out<BM, BN>(
          st, table, p.out, n0, p.Cout, [&](const bw::RowInfo& ri, int n, float(&v)[4]) {
            const float4 d = *reinterpret_cast<const float4*>(p.demod + (int64_t)ri.b * p.Cout + n);
            const float4 c = *reinterpret_cast<const float4*>(p.bias + n);
            v[0] = finish(v[0], d.x, ri.nz, c.x);
            v[1] = finish(v[1], d.y, ri.nz, c.y);
            v[2] = finish(v[2], d.z, ri.nz, c.z);
            v[3] = finish(v[3], d.w, ri.nz, c.w);
          });
    }
  }
}

template <int BN>
int launch_tf32(const float* xm, const float* planes, ConvArgs p, cudaStream_t s) {
  using TL = Tile<BN>;
  // base pixels (x - 1, y - 1) of the H x W pixels: the bounding box
  // [-1, dim - 2] on both axes
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  CUtensorMap xmap, wmap;
  cudaError_t e = im2col_map(&xmap, xm, p.B, p.H, p.W, p.Cin, lower, upper);
  if (e == cudaSuccess) e = weight_map(&wmap, planes, p.Cin, p.Cout, BN);
  auto kernel = styled_conv3x3_kernel<BN>;
  if (e == cudaSuccess) e = bf16wg::set_smem(kernel, TL::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long M = (long long)p.B * p.H * p.W;
  const dim3 grid((unsigned)((M + BM - 1) / BM) * p.tiles_n, p.nsplit);
  kernel<<<grid, NT, TL::SMEM_BYTES, s>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
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

struct ConvBf16Args {
  const float* demod;  // (B, Cout)
  const float* noise;  // (Nb, H, W)
  long long noise_bs;  // 0: broadcast over B
  const float* nw;     // scalar
  const float* bias;   // (Cout,)
  __nv_bfloat16* out;  // (B, H, W, Cout)
  float* part;         // (nsplit, M, Cout) if nsplit > 1
  int nsplit, B, H, W, Cin, Cout;
  int tw, th, nb;            // the A box: pixels a tile, tw x th x nb
  int tiles_x, tiles_y, tiles_n, chunks;
};

// The bf16 body: the 9-tap implicit GEMM on bf16_wgmma.cuh, a BM x BN tile.
// Tile (blockIdx.x / tiles_n) covers pixels x0 .. x0 + tw - 1, rows y0 ..
// y0 + th - 1 of images b0 .. b0 + nb - 1 (tile row r: x fastest, then y,
// then b); tap (dy, dx)'s A is the same box at (x0 + dx - 1, y0 + dy - 1),
// TMA filling what lies outside the image with zeros. Splits (blockIdx.y)
// take taps 9 z / nsplit .. 9 (z + 1) / nsplit and write raw sums.
template <int BM, int BN>
__global__ void __launch_bounds__(bf16wg::NT, 1)
styled_conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const ConvBf16Args p) {
  namespace bw = bf16wg;
  using TL = bw::Tile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  const bw::Ring<BM, BN> ring = bw::ring_setup<BM, BN>(smem_raw);

  const int tm = blockIdx.x / p.tiles_n;
  const int n0 = (blockIdx.x - tm * p.tiles_n) * BN;
  const int x0 = (tm % p.tiles_x) * p.tw;
  const int y0 = (tm / p.tiles_x % p.tiles_y) * p.th;
  const int b0 = tm / (p.tiles_x * p.tiles_y) * p.nb;
  const int z = blockIdx.y;
  const int t0 = 9 * z / p.nsplit, t1 = 9 * (z + 1) / p.nsplit;

  if (threadIdx.x >= bw::CONSUMERS) {  // the producer warpgroup: one thread works
    if constexpr (TL::REBALANCE) bw::setmaxnreg_dec<bw::PRODUCER_REGS>();
    if (threadIdx.x == bw::CONSUMERS) {
      const CUtensorMap* xs = &xmap;
      const CUtensorMap* ws = &wmap;
      bw::prefetch_map(xs);
      bw::prefetch_map(ws);
      const uint32_t bytes = 2 * bw::BK * p.tw * p.th * p.nb + TL::B_BYTES;
      bw::produce<BM, BN>(ring, t1 - t0, p.chunks, bytes,
                      [=](uint32_t a, uint32_t b, uint32_t bar, int tap, int c0) {
                        tap += t0;
                        const int dy = tap / 3, dx = tap - 3 * dy;
                        bw::tma_tile_4d(a, xs, bar, c0, x0 + dx - 1, y0 + dy - 1, b0);
                        bw::tma_tile_3d(b, ws, bar, c0, n0, tap);
                      });
    }
  } else {  // the two consumer warpgroups
    if constexpr (TL::REBALANCE) bw::setmaxnreg_inc<bw::CONSUMER_REGS>();
    const int HW = p.H * p.W;
    const int64_t M = (int64_t)p.B * HW;
    bw::RowInfo* table = ring.table();
    if (threadIdx.x < BM) {  // tile row r's pixel, while the first stages load
      const int r = threadIdx.x;
      const int xi = r % p.tw, q = r / p.tw;
      const int yi = q % p.th, bi = q / p.th;
      const int x = x0 + xi, y = y0 + yi, b = b0 + bi;
      const bool ok = bi < p.nb && b < p.B && y < p.H && x < p.W;
      const int64_t pix = ((int64_t)b * p.H + y) * p.W + x;
      bw::RowInfo ri;
      ri.off = ok ? (pix + (p.nsplit > 1 ? z * M : 0)) * p.Cout : -1;
      ri.b = b;
      ri.nz = ok && p.nsplit == 1 ? *p.nw * p.noise[b * p.noise_bs + (pix - (int64_t)b * HW)]
                                  : 0.f;
      table[r] = ri;
    }
    float acc[TL::MI][TL::ACC];
    bw::consume<BM, BN>(acc, ring, (t1 - t0) * p.chunks, threadIdx.x >> 7);
    bw::consumers_sync();  // every stage consumed: the ring is free
    float* st = ring.staged();
    bw::stage_acc<BM, BN>(st, acc);
    bw::consumers_sync();
    if (p.nsplit > 1) {  // this split's raw sums
      bw::store_out<BM, BN>(st, table, p.part, n0, p.Cout,
                            [](const bw::RowInfo&, int, float(&)[4]) {});
    } else {
      bw::store_out<BM, BN>(
          st, table, p.out, n0, p.Cout, [&](const bw::RowInfo& ri, int n, float(&v)[8]) {
            const float4* d = reinterpret_cast<const float4*>(p.demod + (int64_t)ri.b * p.Cout + n);
            const float4* bs = reinterpret_cast<const float4*>(p.bias + n);
            const float4 d0 = d[0], d1 = d[1], c0 = bs[0], c1 = bs[1];
            const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
            const float cc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = finish(v[k], dd[k], ri.nz, cc[k]);
          });
    }
  }
}

template <int BM, int BN>
int launch_bf16(const void* xm, const void* w, ConvBf16Args p, int stages,
                cudaStream_t s) {
  using TL = bf16wg::Tile<BM, BN>;
  if (stages != TL::STAGES) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t e = bf16wg::pixel_box_map(&xmap, xm, p.B, p.H, p.W, p.Cin, p.tw, p.th, p.nb);
  if (e == cudaSuccess) e = bf16wg::weight_map(&wmap, w, p.Cin, p.Cout, BN);
  auto kernel = styled_conv3x3_bf16_kernel<BM, BN>;
  if (e == cudaSuccess) e = bf16wg::set_smem(kernel, TL::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.tiles_x * p.tiles_y * ((p.B + p.nb - 1) / p.nb) * p.tiles_n, p.nsplit);
  kernel<<<grid, bf16wg::NT, TL::SMEM_BYTES, s>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 entry: w as (3, 3, Cin, Cout), split into ``planes`` (2, 9,
// Cout, Cin; the wrapper's scratch) before the GEMM. The plan
// (ops/modulated_conv.py tf32_plan): ``bn`` the tile's width (32, 64 or
// 128), ``stages`` the ring's depth and ``tiles_m`` the 128-pixel tiles,
// all checked against the kernel's.
extern "C" int gk_styled_conv3x3(const float* xm, const float* w, float* planes,
                                 const float* demod, const float* noise,
                                 long long noise_bs, const float* nw,
                                 const float* bias, float* out, float* part,
                                 int nsplit, int B, int H, int W, int Cin,
                                 int Cout, int bn, int stages, int tiles_m,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  if ((nsplit != 1 && nsplit != 3 && nsplit != 9) || Cin % 4 || Cout % 4 ||
      bn != tile_n(Cout) || tiles_m != (M + BM - 1) / BM)
    return (int)cudaErrorInvalidValue;
  if (stages != (bn == 32 ? Tile<32>::STAGES : bn == 64 ? Tile<64>::STAGES : Tile<128>::STAGES))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = split_weights(w, planes, Cin, Cout, s);
  if (e != cudaSuccess) return (int)e;
  ConvArgs p{demod, noise, noise_bs, nw, bias, out, part, nsplit, B, H, W, Cin, Cout,
             (Cout + bn - 1) / bn, (Cin + BK - 1) / BK};
  const int rc = bn == 32   ? launch_tf32<32>(xm, planes, p, s)
                 : bn == 64 ? launch_tf32<64>(xm, planes, p, s)
                            : launch_tf32<128>(xm, planes, p, s);
  if (rc != 0 || nsplit == 1) return rc;
  const int64_t total = M * (Cout / 4);
  styled_conv_epilogue_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, nsplit, demod, noise, noise_bs, nw, bias, out, (int)M, H * W, Cout);
  return (int)cudaGetLastError();
}

// The bf16 entry: xm, w and out bf16; demod, noise, nw, bias and the split
// scratch float32. The plan (ops/modulated_conv.py bf16_plan): ``bm`` the
// tile's rows (128 or 256, the latter at most 128 wide), ``bn`` its width
// (16 to 256), ``stages`` the ring's depth (checked against the kernel's),
// (tw, th, nb) the pixel box of a tile.
extern "C" int gk_styled_conv3x3_bf16(const void* xm, const void* w,
                                      const float* demod, const float* noise,
                                      long long noise_bs, const float* nw,
                                      const float* bias, void* out, float* part,
                                      int nsplit, int B, int H, int W, int Cin,
                                      int Cout, int bm, int bn, int stages, int tw,
                                      int th, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nsplit != 1 && nsplit != 3 && nsplit != 9) || Cin % 8 || Cout % 8 ||
      bn != bf16wg::tile_n(Cout) || (bm != 128 && (bm != 256 || bn > 128)) ||
      tw < 1 || th < 1 || nb < 1 || tw > 256 || th > 256 || nb > 256 ||
      tw * th * nb > bm)
    return (int)cudaErrorInvalidValue;
  ConvBf16Args p{demod, noise, noise_bs, nw, bias, static_cast<__nv_bfloat16*>(out),
                 part, nsplit, B, H, W, Cin, Cout, tw, th, nb,
                 (W + tw - 1) / tw, (H + th - 1) / th, (Cout + bn - 1) / bn,
                 (Cin + bf16wg::BK - 1) / bf16wg::BK};
  int rc;
  if (bm == 256) {
    switch (bn) {
      case 16: rc = launch_bf16<256, 16>(xm, w, p, stages, s); break;
      case 32: rc = launch_bf16<256, 32>(xm, w, p, stages, s); break;
      case 64: rc = launch_bf16<256, 64>(xm, w, p, stages, s); break;
      default: rc = launch_bf16<256, 128>(xm, w, p, stages, s);
    }
  } else {
    switch (bn) {
      case 16: rc = launch_bf16<128, 16>(xm, w, p, stages, s); break;
      case 32: rc = launch_bf16<128, 32>(xm, w, p, stages, s); break;
      case 64: rc = launch_bf16<128, 64>(xm, w, p, stages, s); break;
      case 128: rc = launch_bf16<128, 128>(xm, w, p, stages, s); break;
      default: rc = launch_bf16<128, 256>(xm, w, p, stages, s);
    }
  }
  if (rc != 0 || nsplit == 1) return rc;
  const int M = B * H * W;
  const int64_t total = (int64_t)M * (Cout / 4);
  styled_conv_epilogue_kernel<__nv_bfloat16>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          part, nsplit, demod, noise, noise_bs, nw, bias, p.out, M, H * W, Cout);
  return (int)cudaGetLastError();
}
