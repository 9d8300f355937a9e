// Fused bias + leaky-ReLU + scale and its backward, on row-major (rows, C)
// float32:
//
//   forward   y  = (m >= 0 ? v : v*slope) * scale,  v = x + bias[c],
//             m = v (the activation) or a given tensor (the mask source);
//   backward  dx = (y >= 0 ? g : g*slope) * scale,  db[c] = sum_rows dx.
//
// Replaces ganecdotes_tpu/ops/fused_act.py::fused_leaky_relu_pallas (the
// pallas_call at fused_act.py:53) and its custom_vjp backward _flr_bwd
// (fused_act.py:87-91, jnp in the JAX package). The forward with the mask
// read from y is the VJP of the backward with respect to g, given (gdx,
// gdb): bias = gdb, x = gdx. So the two kernels serve every order of
// derivative (ops/fused_act.py).
//
// Bound: bytes. A few flops per element against 8 bytes (forward), 12 (the
// forward with a mask tensor, the backward) far below the card's ~20
// flop/byte fp32 balance point. Design, from the wrapper's plan
// (ops/fused_act.py::plan): a block is (tx, ty) threads; thread x owns one
// channel group of VEC channels (a float4 when C % 4 == 0, else one
// channel), fixed for its life, and its bias group sits in registers; y
// walks rows, and the grid's x blocks stride over the rows (grid y covers
// a row wider than tx groups). No integer division per element; a warp's
// lanes read and write contiguous bytes (whole rows when the row holds at
// most tx groups). Every float step is a separately rounded _rn intrinsic
// in the plain version's order, so both kernels equal their plain versions
// bit for bit, db aside.
//
// db: each thread sums the dx of the rows it visits, the block sums its ty
// threads' partials in increasing y through shared memory and writes one
// row of a (gridDim.x, C) workspace; a second, short launch sums each
// column in a fixed order (column_sum_kernel). No atomics: two runs give
// the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the most threads a plan's block has; 8 such blocks fill an SM, as the
// plan counts them (at most 32 registers a thread)
constexpr int THREADS = 256;

template <int VEC>
struct Group {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Group<VEC> load(const float* __restrict__ p) {
  Group<VEC> g;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    g.v[0] = t.x; g.v[1] = t.y; g.v[2] = t.z; g.v[3] = t.w;
  } else {
    g.v[0] = *p;
  }
  return g;
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p, const Group<VEC>& g) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(g.v[0], g.v[1], g.v[2], g.v[3]);
  } else {
    *p = g.v[0];
  }
}

__device__ __forceinline__ float act(float v, float m, float slope, float scale) {
  return __fmul_rn(m >= 0.f ? v : __fmul_rn(v, slope), scale);
}

// MASK: the sign test reads m[] (the VJP of the backward), not x + bias
template <int VEC, bool MASK>
__global__ void __launch_bounds__(THREADS, 8)
    fused_leaky_relu_kernel(const float* __restrict__ x,
                            const float* __restrict__ bias,
                            const float* __restrict__ m, float* __restrict__ y,
                            int rows, int c, float slope, float scale) {
  const int q = blockIdx.y * blockDim.x + threadIdx.x;  // channel group
  if (q * VEC >= c) return;
  const int c0 = q * VEC;
  Group<VEC> b;
#pragma unroll
  for (int i = 0; i < VEC; ++i) b.v[i] = bias ? bias[c0 + i] : 0.f;
  const int r0 = blockIdx.x * blockDim.y + threadIdx.y;
  const int step = gridDim.x * blockDim.y;
  const int64_t stride = (int64_t)step * c;
  int64_t off = (int64_t)r0 * c + c0;
  for (int r = r0; r < rows; r += step, off += stride) {
    Group<VEC> v = load<VEC>(x + off);
    Group<VEC> s = {};
    if constexpr (MASK) s = load<VEC>(m + off);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (bias) v.v[i] = __fadd_rn(v.v[i], b.v[i]);
      v.v[i] = act(v.v[i], MASK ? s.v[i] : v.v[i], slope, scale);
    }
    store<VEC>(y + off, v);
  }
}

// dx in one pass over g and y; with ``part``, each block's column sums of
// dx into part[blockIdx.x, :]
template <int VEC>
__global__ void __launch_bounds__(THREADS, 8)
    fused_leaky_relu_bwd_kernel(const float* __restrict__ g,
                                const float* __restrict__ y,
                                float* __restrict__ dx, float* __restrict__ part,
                                int rows, int c, float slope, float scale) {
  __shared__ float red[THREADS * VEC];
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = q * VEC < c;
  Group<VEC> acc;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.v[i] = 0.f;
  if (active) {
    // the thread's rows r0, r0 + step, ...: one offset advanced by a
    // fixed stride (no 64-bit multiply in the loop)
    const int r0 = blockIdx.x * blockDim.y + threadIdx.y;
    const int step = gridDim.x * blockDim.y;
    const int64_t stride = (int64_t)step * c;
    int64_t off = (int64_t)r0 * c + q * VEC;
    for (int r = r0; r < rows; r += step, off += stride) {
      Group<VEC> d = load<VEC>(g + off);
      const Group<VEC> s = load<VEC>(y + off);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        d.v[i] = act(d.v[i], s.v[i], slope, scale);
        acc.v[i] = __fadd_rn(acc.v[i], d.v[i]);
      }
      store<VEC>(dx + off, d);
    }
  }
  if (!part) return;  // uniform over the launch
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[t * VEC + i] = acc.v[i];
  __syncthreads();
  if (threadIdx.y != 0 || !active) return;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float s = red[threadIdx.x * VEC + i];
    for (int k = 1; k < (int)blockDim.y; ++k)
      s = __fadd_rn(s, red[(k * blockDim.x + threadIdx.x) * VEC + i]);
    part[(int64_t)blockIdx.x * c + q * VEC + i] = s;
  }
}

// db[j] = the sum of part[k, j] over k < nblocks: a (32, SUM_ROWS) block
// per 32 columns, thread (x, y) summing rows k = y, y + SUM_ROWS, ... of
// column j in increasing k, then thread (x, 0) those SUM_ROWS sums in
// increasing y. Coalesced across x; each thread walks nblocks / SUM_ROWS
// rows, not all of them.
constexpr int SUM_ROWS = 32;

__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ db, int nblocks, int c) {
  __shared__ float red[SUM_ROWS][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < c) {
    for (int k = threadIdx.y; k < nblocks; k += SUM_ROWS)
      s = __fadd_rn(s, part[(int64_t)k * c + j]);
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || j >= c) return;
  float total = red[0][threadIdx.x];
  for (int k = 1; k < SUM_ROWS; ++k) total = __fadd_rn(total, red[k][threadIdx.x]);
  db[j] = total;
}

}  // namespace

// The plan (vec, tx, ty, gx, gy): VEC channels a thread, a (tx, ty) block,
// a (gx, gy) grid. ``m`` NULL: the mask is x + bias.
extern "C" int gk_fused_leaky_relu(const float* x, const float* bias,
                                   const float* m, float* y, int rows, int c,
                                   float slope, float scale, int vec, int tx,
                                   int ty, int gx, int gy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy), block(tx, ty);
  if (vec == 4) {
    if (m) fused_leaky_relu_kernel<4, true><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
    else fused_leaky_relu_kernel<4, false><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
  } else {
    if (m) fused_leaky_relu_kernel<1, true><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
    else fused_leaky_relu_kernel<1, false><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
  }
  return (int)cudaGetLastError();
}

// dx, and with ``db`` the bias gradient through ``part`` (gx, c): two
// launches on the stream, the second one short.
extern "C" int gk_fused_leaky_relu_bwd(const float* g, const float* y, float* dx,
                                       float* part, float* db, int rows, int c,
                                       float slope, float scale, int vec, int tx,
                                       int ty, int gx, int gy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy), block(tx, ty);
  float* p = db ? part : nullptr;
  if (vec == 4)
    fused_leaky_relu_bwd_kernel<4><<<grid, block, 0, s>>>(g, y, dx, p, rows, c, slope, scale);
  else
    fused_leaky_relu_bwd_kernel<1><<<grid, block, 0, s>>>(g, y, dx, p, rows, c, slope, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !db) return (int)err;
  column_sum_kernel<<<(c + 31) / 32, dim3(32, SUM_ROWS), 0, s>>>(part, db, gx, c);
  return (int)cudaGetLastError();
}
