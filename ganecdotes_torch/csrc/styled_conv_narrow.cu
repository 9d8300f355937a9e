// The narrow variants of kernels 3 and 4: StyleGAN2's StyledConv bodies at
// Cout of 16, 32 or 64 (BagGAN's lean width map: 64 channels at 64^2, 32 at
// 128^2, 16 at 256^2), on the fp32 SIMT units:
//
//   non-up: out = lrelu(demod * conv3x3(x * s, W) + nw * noise + bias) * sqrt(2)
//   up:     out = lrelu(blur(demod * convT_s2(x * s, W)) + nw * noise + bias) * sqrt(2)
//
// Replaces, at these widths, ganecdotes_tpu/ops/modulated_conv_pallas.py
// ::styled_conv3x3 (pallas_call :212) and ::styled_up_conv3x3 (pallas_call
// :466); ops/modulated_conv.py picks this variant from the shape
// (``variant``), the 3xTF32 GEMMs of styled_conv.cu / styled_up_conv.cu
// take every other width.
//
// Why another kernel at these widths: the GEMM main loop's 128 x 128 tile
// holds 16-64 real output channels, so most of every MMA is zero fill, and
// its wrapper adds a pass for x * s and a permute of W. Here:
//
// * Bound: bytes at Cout = 16 for a 256^2 map (2.4 GFLOP against 67 MB per
//   batch of 8: 0.036 ms of fp32 FMAs, 0.020 ms of bytes), operations at
//   the wider rows. Plain fp32 FMAs: exact float32 products, no 3xTF32
//   split, and the SIMT rate is within 2x of the byte bound here.
// * Nothing of x * s materialised: a block owns a tile of output pixels
//   of one image and all of Cout. It stages its input halo once per chunk
//   of 16 input channels in shared memory, multiplied by s[b] on the load
//   (the x * s pass of the GEMM path), and the chunk's weights as read
//   from W in its HWIO layout (Cout contiguous: no permute). Each thread
//   accumulates P = 4 vertically adjacent pixels by 8 output channels in
//   registers; a thread reads a column of P + 2 inputs once for the three
//   vertical taps, and 32 consecutive threads of a warp read 32
//   consecutive columns (no bank conflicts), the weights as broadcasts.
//   The non-up body's demod, noise, bias and leaky-ReLU epilogue runs in
//   registers before its single write.
// * The up body is the stride-2 transposed conv, then the blur: T = convT
//   (x * s, W), (B, 2H+1, 2W+1, Cout), in four phase classes (py, px) of T
//   (row Y = 2m + py reads x row m with kernel row 0 and x row m - 1 with
//   kernel row 2 when py = 0, x row m with kernel row 1 when py = 1; the
//   same per column), so a class has 4, 2, 2 or 1 live taps of the 3 x 3
//   around (m, n) and the whole does 9 * Cin * Cout multiply-adds per input
//   pixel: the same tiles and loops as the non-up body with blockIdx.z the
//   class and its dead taps neither staged nor run (uniform over the
//   block), over the (H+1) x (W+1) grid of class positions, writing raw
//   sums to T (a scratch tensor the wrapper allocates).
//   narrow_blur_epilogue_kernel then blurs T
//   ([1, 3, 3, 1] as separable taps, a thread per 2 x 2 outputs and 4
//   channels) and runs the epilogue with demod after the blur (it commutes
//   with the depthwise blur).
//
// On grids too small to fill the SMs (B = 1) the wrapper
// (ops/modulated_conv.py::narrow_splits) splits the 16-channel chunks over
// up to 8 blocks that form one thread-block cluster: each leaves its raw
// sums in its shared memory, and after a cluster barrier each finishes a
// share of the tile's outputs, adding the splits' sums from distributed
// shared memory in split order (no scratch tensor, no second launch, no
// atomics: two launches give the same bits). Requires Cin % 4 == 0 and
// 16-byte-aligned pointers (the wrapper checks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads per block
constexpr int CK = 16;   // input channels staged per chunk
constexpr int Q = 8;     // output channels per thread
constexpr int P = 4;     // pixels (rows) per thread
constexpr int MAX_SPLITS = 8;  // a portable cluster
constexpr float SQRT2 = 1.4142135623730951f;

template <int COUT>
struct Tile {
  static constexpr int NG = COUT / Q;  // thread groups over Cout
  static constexpr int PG = NT / NG;   // threads per group, one column each
  static constexpr int TW = 32;        // tile columns: one warp's columns
  static constexpr int RG = PG / TW;   // row groups of P rows
  static constexpr int TH = P * RG;    // tile rows
  static constexpr int ROWS = TH + 2, COLS = TW + 2;
  // one channel's plane of the halo, padded to 2 mod 8 floats, so that the
  // four channels a thread stores from one float4 land in distinct banks
  static constexpr int PL = ((ROWS * COLS - 2 + 7) / 8) * 8 + 2;
  static constexpr int XS = CK * PL;            // staged input floats
  static constexpr int WS = 9 * CK * COUT;      // staged weight floats
  static constexpr int SMEM = (XS + WS) * 4;
  static_assert(COUT % Q == 0 && PG % TW == 0, "tile shape");
  // a split's raw sums, [P][NT][Q], reuse the staging buffers
  static_assert(P * Q * NT <= XS + WS, "split sums fit in shared memory");
};

struct BlurTaps {
  float k[4];  // flipped 1-D taps: out[o] = sum_t k[t] * T[o - 1 + t]
};

__device__ __forceinline__ float finish(float acc, float d, float nz, float bias) {
  float o = acc * d;
  o = o + nz;
  o = o + bias;
  return (o >= 0.f ? o : 0.2f * o) * SQRT2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

struct Args {
  const float* x;      // (B, H, W, Cin)
  const float* w;      // (3, 3, Cin, Cout)
  const float* s;      // (B, Cin)
  const float* demod;  // (B, Cout)
  const float* noise;  // (Nb, OH, OW)
  int64_t noise_bs;    // 0: broadcast over B
  const float* nw;     // scalar
  const float* bias;   // (Cout,)
  float* out;          // (B, OH, OW, Cout)
  float* t;            // up: T, (B, 2H+1, 2W+1, Cout)
  int nsplit, B, H, W, Cin;
};

// The kernel row (or column) that tap d (offset d - 1 from the class
// position) carries in phase class p of the transposed conv, -1 if none:
// p = 0: d = 1 -> 0, d = 0 -> 2; p = 1: d = 1 -> 1.
__device__ __forceinline__ int convt_tap(int p, int d) {
  return p == 0 ? (d == 1 ? 0 : (d == 0 ? 2 : -1)) : (d == 1 ? 1 : -1);
}

// whether kernel row (or column) k is live in phase class p
__device__ __forceinline__ bool convt_live(int p, int k) {
  return p == 0 ? k != 1 : k == 1;
}

// Sums of channels n .. n + 3 at row gy, column gx of the tile's grid:
// non-up, the epilogue to out; up, the raw sums to T where the class
// position lies inside it.
template <int COUT, bool UP>
__device__ __forceinline__ void store4(const Args& a, int b, int gy, int gx, int phase,
                                       int n, float4 v, float nwv) {
  if (UP) {
    const int Y = 2 * gy + (phase >> 1), X = 2 * gx + (phase & 1);
    if (Y > 2 * a.H || X > 2 * a.W) return;
    *reinterpret_cast<float4*>(
        a.t + (((int64_t)b * (2 * a.H + 1) + Y) * (2 * a.W + 1) + X) * COUT + n) = v;
    return;
  }
  if (gy >= a.H || gx >= a.W) return;
  const float nz = nwv * a.noise[(int64_t)b * a.noise_bs + (int64_t)gy * a.W + gx];
  const float4 d = ld4(a.demod + (int64_t)b * COUT + n);
  const float4 bb = ld4(a.bias + n);
  *reinterpret_cast<float4*>(a.out + (((int64_t)b * a.H + gy) * a.W + gx) * COUT + n) =
      make_float4(finish(v.x, d.x, nz, bb.x), finish(v.y, d.y, nz, bb.y),
                  finish(v.z, d.z, nz, bb.z), finish(v.w, d.w, nz, bb.w));
}

// blockIdx: x the spatial tile, y the image, z = class * nsplit + split
// (class 0 for the non-up body); the nsplit blocks of a (tile, image,
// class) are one cluster. A split sums its share of the 16-channel chunks.
// The up body's tiles cover the (H+1) x (W+1) class positions.
template <int COUT, bool UP>
__global__ void __launch_bounds__(NT)
styled_conv_narrow_kernel(const Args a, int tiles_x) {
  using T = Tile<COUT>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;          // [CK][ROWS][COLS], plane stride PL
  float* ws = smem + T::XS;  // [3][3][CK][COUT], W's chunk

  const int H = a.H, W = a.W, Cin = a.Cin;
  const int tid = threadIdx.x;
  const int ng = tid / T::PG, pg = tid - ng * T::PG;
  const int col = pg % T::TW, rg = pg / T::TW;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * T::TH;
  const int x0 = (blockIdx.x % tiles_x) * T::TW;
  const int n0 = ng * Q;
  const int split = blockIdx.z % a.nsplit, phase = blockIdx.z / a.nsplit;
  const int nchunks = (Cin + CK - 1) / CK;
  const int k0 = split * nchunks / a.nsplit, k1 = (split + 1) * nchunks / a.nsplit;
  // the kernel row / column each tap offset carries (-1: a dead tap)
  int ky[3], kx[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ky[d] = UP ? convt_tap(phase >> 1, d) : d;
    kx[d] = UP ? convt_tap(phase & 1, d) : d;
  }

  float acc[P][Q];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[p][q] = 0.f;

  const float* xb = a.x + (int64_t)b * H * W * Cin;
  const float* sb = a.s + (int64_t)b * Cin;
  for (int c0 = k0 * CK; c0 < k1 * CK; c0 += CK) {
    __syncthreads();  // the previous chunk's reads are done
    // the halo rows y0-1 .. y0+TH, columns x0-1 .. x0+TW, channels
    // c0 .. c0+CK, times s; zero outside the image and past Cin
    constexpr int C4 = CK / 4;
    constexpr int N4 = T::ROWS * T::COLS * C4;
    for (int i = tid; i < N4; i += NT) {
      const int c4 = i % C4, pix = i / C4;
      const int r = pix / T::COLS, cc = pix - r * T::COLS;
      const int gy = y0 - 1 + r, gx = x0 - 1 + cc, c = c0 + 4 * c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = ld4(xb + ((int64_t)gy * W + gx) * Cin + c);
        const float4 sv = ld4(sb + c);
        v.x *= sv.x;
        v.y *= sv.y;
        v.z *= sv.z;
        v.w *= sv.w;
      }
      float* d = xs + 4 * c4 * T::PL + pix;
      d[0] = v.x;
      d[T::PL] = v.y;
      d[2 * T::PL] = v.z;
      d[3 * T::PL] = v.w;
    }
    // the chunk's weights, [ky][kx][c][n]: up, only the class's live taps
    constexpr int N4W = COUT / 4;
    for (int i = tid; i < 9 * CK * N4W; i += NT) {
      const int n4 = i % N4W, rest = i / N4W;
      const int c = rest % CK, tap = rest / CK;
      if (UP && !(convt_live(phase >> 1, tap / 3) && convt_live(phase & 1, tap % 3)))
        continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < Cin) v = ld4(a.w + ((int64_t)tap * Cin + c0 + c) * COUT + 4 * n4);
      *reinterpret_cast<float4*>(ws + 4 * i) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < CK; ++c) {
      const float* xc = xs + c * T::PL + rg * P * T::COLS + col;
      const float* wc = ws + c * COUT + n0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (kx[dx] < 0) continue;
        float v[P + 2];
#pragma unroll
        for (int r = 0; r < P + 2; ++r) v[r] = xc[r * T::COLS + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          if (ky[dy] < 0) continue;
          const float* wt = wc + (ky[dy] * 3 + kx[dx]) * CK * COUT;
          const float4 wa = *reinterpret_cast<const float4*>(wt);
          const float4 wb = *reinterpret_cast<const float4*>(wt + 4);
          const float wq[Q] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int q = 0; q < Q; ++q) acc[p][q] = fmaf(v[p + dy], wq[q], acc[p][q]);
        }
      }
    }
  }

  const float nwv = UP ? 0.f : *a.nw;
  if (a.nsplit > 1) {
    // this split's raw sums to its shared memory, [p][thread][q]
    __syncthreads();  // the staging buffers are read
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float4* d = reinterpret_cast<float4*>(smem + (p * NT + tid) * Q);
      d[0] = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      d[1] = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // this block finishes every nsplit-th group of 4 sums of the tile,
    // starting at its split: all splits' group read first, then added in
    // split order
    for (int e = split * NT + tid; e < P * NT * (Q / 4); e += a.nsplit * NT) {
      float4 u[MAX_SPLITS];
#pragma unroll
      for (int z = 0; z < MAX_SPLITS; ++z)
        if (z < a.nsplit)
          u[z] = reinterpret_cast<const float4*>(cluster.map_shared_rank(smem, z))[e];
      float4 v = u[0];
#pragma unroll
      for (int z = 1; z < MAX_SPLITS; ++z)
        if (z < a.nsplit) {
          v.x += u[z].x;
          v.y += u[z].y;
          v.z += u[z].z;
          v.w += u[z].w;
        }
      // the group's owner: thread t, pixel row p, channels 4h.. of its 8
      const int h = e & 1, t = (e >> 1) % NT, p = (e >> 1) / NT;
      const int tng = t / T::PG, tpg = t - tng * T::PG;
      store4<COUT, UP>(a, b, y0 + (tpg / T::TW) * P + p, x0 + tpg % T::TW, phase,
                       tng * Q + 4 * h, v, nwv);
    }
    cluster.sync();  // no block leaves while another reads its sums
    return;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int gy = y0 + rg * P + p, gx = x0 + col;
    store4<COUT, UP>(a, b, gy, gx, phase, n0,
                     make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]), nwv);
    store4<COUT, UP>(a, b, gy, gx, phase, n0 + 4,
                     make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]), nwv);
  }
}

// out = lrelu(demod * blur(T) + nw * noise + bias) * sqrt(2) on the
// (2H, 2W) grid: a thread owns a 2 x 2 block of outputs and 4 channels,
// reads the 5 x 5 window of T it needs once and blurs it separably
__global__ void narrow_blur_epilogue_kernel(const Args a, int C, BlurTaps kt) {
  const int H = a.H, W = a.W;
  const int C4 = C >> 2;
  const int64_t total = (int64_t)a.B * H * W * C4;
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
  for (int y = 0; y < 2; ++y)
#pragma unroll
    for (int e = 0; e < 2; ++e) o[y][e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // T rows 2 yb - 1 .. 2 yb + 3 and columns 2 xb - 1 .. 2 xb + 3
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int Y = 2 * yb - 1 + u;
    if (Y < 0 || Y >= TH) continue;
    const float* trow = a.t + ((int64_t)b * TH + Y) * TW * C + c;
    float4 v[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int X = 2 * xb - 1 + e;
      v[e] = (X >= 0 && X < TW) ? *reinterpret_cast<const float4*>(trow + (int64_t)X * C)
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
      for (int y = 0; y < 2; ++y) {  // vertical tap u - y of output row 2 yb + y
        const int t = u - y;
        if (t < 0 || t > 3) continue;
        o[y][e].x += kt.k[t] * hz.x;
        o[y][e].y += kt.k[t] * hz.y;
        o[y][e].z += kt.k[t] * hz.z;
        o[y][e].w += kt.k[t] * hz.w;
      }
    }
  }

  const float nwv = *a.nw;
  const float4 d = ld4(a.demod + (int64_t)b * C + c);
  const float4 bb = ld4(a.bias + c);
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oy = 2 * yb + y, ox = 2 * xb + e;
      const float nz = nwv * a.noise[(int64_t)b * a.noise_bs + (int64_t)oy * OW + ox];
      *reinterpret_cast<float4*>(a.out + (((int64_t)b * OH + oy) * OW + ox) * C + c) =
          make_float4(finish(o[y][e].x, d.x, nz, bb.x), finish(o[y][e].y, d.y, nz, bb.y),
                      finish(o[y][e].z, d.z, nz, bb.z), finish(o[y][e].w, d.w, nz, bb.w));
    }
  }
}

template <int COUT, bool UP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = Tile<COUT>;
  auto kernel = styled_conv_narrow_kernel<COUT, UP>;
  // the shared-memory limit, set once per device: at B = 1 the call's host
  // time is its time, and setting it would be part of every launch
  static std::atomic<unsigned> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((set_on.load() >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) set_on.fetch_or(1u << dev);
  }
  // up: the class positions, one more row and column than the input
  const int GH = UP ? a.H + 1 : a.H, GW = UP ? a.W + 1 : a.W;
  const int tiles_x = (GW + T::TW - 1) / T::TW;
  const int tiles_y = (GH + T::TH - 1) / T::TH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_x * tiles_y, a.B, (UP ? 4 : 1) * a.nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;  // the splits of a tile: one cluster
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = a.nsplit;
  cfg.attrs = &cluster;
  cfg.numAttrs = a.nsplit > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, tiles_x);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool UP>
cudaError_t by_cout(int Cout, const Args& a, cudaStream_t stream) {
  switch (Cout) {
    case 16:
      return launch<16, UP>(a, stream);
    case 32:
      return launch<32, UP>(a, stream);
    case 64:
      return launch<64, UP>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The non-up body (up = 0), one launch; or the 2x up body (up = 1) on the
// (2H, 2W) grid, two: the transposed conv into ``t`` ((B, 2H+1, 2W+1,
// Cout) floats), then the blur and the epilogue. Cout 16, 32 or 64; the
// 16-channel chunks split nsplit ways (1 to the number of chunks, at most
// 8), the splits of a tile one cluster.
extern "C" int gk_styled_conv3x3_narrow(const float* x, const float* w,
                                        const float* s, const float* demod,
                                        const float* noise, long long noise_bs,
                                        const float* nw, const float* bias,
                                        float* out, float* t, int nsplit, int B,
                                        int H, int W, int Cin, int Cout, int up,
                                        float k0, float k1, float k2, float k3,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 4 != 0 || Cout % 4 != 0 || nsplit < 1 || nsplit > MAX_SPLITS ||
      nsplit > (Cin + CK - 1) / CK)
    return (int)cudaErrorInvalidValue;
  const Args a = {x, w, s, demod, noise, noise_bs, nw, bias, out, t,
                  nsplit, B, H, W, Cin};
  if (!up) return (int)by_cout<false>(Cout, a, st);
  cudaError_t e = by_cout<true>(Cout, a, st);
  if (e != cudaSuccess) return (int)e;
  const BlurTaps kt = {{k3, k2, k1, k0}};  // flipped once here: true convolution
  const int64_t total = (int64_t)B * H * W * (Cout / 4);
  narrow_blur_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a, Cout, kt);
  return (int)cudaGetLastError();
}
