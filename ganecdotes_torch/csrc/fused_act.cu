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
//
// bfloat16 (the _bf16 entries): the same kernels instantiated on bf16
// storage, 8 bytes a thread's group of 4. Each element is converted to fp32
// on the load, the same fp32 steps run, and the result is rounded once to
// bf16 on the store (__float2bfloat16_rn); db's partial and column sums stay
// fp32 and round once. The bytes halve, so the bound halves.
#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ Group<VEC> load(const bf16* __restrict__ p) {
  Group<VEC> g;
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    g.v[0] = a.x; g.v[1] = a.y; g.v[2] = b.x; g.v[3] = b.y;
  } else {
    g.v[0] = __bfloat162float(*p);
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

template <int VEC>
__device__ __forceinline__ void store(bf16* __restrict__ p, const Group<VEC>& g) {
  if constexpr (VEC == 4) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __floats2bfloat162_rn(g.v[0], g.v[1]);
    q[1] = __floats2bfloat162_rn(g.v[2], g.v[3]);
  } else {
    *p = __float2bfloat16_rn(g.v[0]);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// v as the store of a T leaves it (rounded to bf16 for a bf16 tensor)
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float act(float v, float m, float slope, float scale) {
  return __fmul_rn(m >= 0.f ? v : __fmul_rn(v, slope), scale);
}

// MASK: the sign test reads m[] (the VJP of the backward), not x + bias
template <class T, int VEC, bool MASK>
__global__ void __launch_bounds__(THREADS, 8)
    fused_leaky_relu_kernel(const T* __restrict__ x,
                            const T* __restrict__ bias,
                            const T* __restrict__ m, T* __restrict__ y,
                            int rows, int c, float slope, float scale) {
  const int q = blockIdx.y * blockDim.x + threadIdx.x;  // channel group
  if (q * VEC >= c) return;
  const int c0 = q * VEC;
  Group<VEC> b;
#pragma unroll
  for (int i = 0; i < VEC; ++i) b.v[i] = bias ? to_f32(bias[c0 + i]) : 0.f;
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
template <class T, int VEC>
__global__ void __launch_bounds__(THREADS, 8)
    fused_leaky_relu_bwd_kernel(const T* __restrict__ g,
                                const T* __restrict__ y,
                                T* __restrict__ dx, float* __restrict__ part,
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
        // db sums dx as stored (rounded to T), as the plain version sums it
        acc.v[i] = __fadd_rn(acc.v[i], stored(d.v[i], dx));
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

template <class T>
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  T* __restrict__ db, int nblocks, int c) {
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
  put(db + j, total);
}

template <class T>
int launch_fwd(const T* x, const T* bias, const T* m, T* y, int rows, int c,
               float slope, float scale, int vec, int tx, int ty, int gx,
               int gy, cudaStream_t s) {
  const dim3 grid(gx, gy), block(tx, ty);
  if (vec == 4) {
    if (m) fused_leaky_relu_kernel<T, 4, true><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
    else fused_leaky_relu_kernel<T, 4, false><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
  } else {
    if (m) fused_leaky_relu_kernel<T, 1, true><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
    else fused_leaky_relu_kernel<T, 1, false><<<grid, block, 0, s>>>(x, bias, m, y, rows, c, slope, scale);
  }
  return (int)cudaGetLastError();
}

template <class T>
int launch_bwd(const T* g, const T* y, T* dx, float* part, T* db, int rows,
               int c, float slope, float scale, int vec, int tx, int ty,
               int gx, int gy, cudaStream_t s) {
  const dim3 grid(gx, gy), block(tx, ty);
  float* p = db ? part : nullptr;
  if (vec == 4)
    fused_leaky_relu_bwd_kernel<T, 4><<<grid, block, 0, s>>>(g, y, dx, p, rows, c, slope, scale);
  else
    fused_leaky_relu_bwd_kernel<T, 1><<<grid, block, 0, s>>>(g, y, dx, p, rows, c, slope, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !db) return (int)err;
  column_sum_kernel<T><<<(c + 31) / 32, dim3(32, SUM_ROWS), 0, s>>>(part, db, gx, c);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (vec, tx, ty, gx, gy): VEC channels a thread, a (tx, ty) block,
// a (gx, gy) grid. ``m`` NULL: the mask is x + bias.
extern "C" int gk_fused_leaky_relu(const float* x, const float* bias,
                                   const float* m, float* y, int rows, int c,
                                   float slope, float scale, int vec, int tx,
                                   int ty, int gx, int gy, void* stream) {
  return launch_fwd(x, bias, m, y, rows, c, slope, scale, vec, tx, ty, gx, gy,
                    static_cast<cudaStream_t>(stream));
}

// dx, and with ``db`` the bias gradient through ``part`` (gx, c): two
// launches on the stream, the second one short.
extern "C" int gk_fused_leaky_relu_bwd(const float* g, const float* y, float* dx,
                                       float* part, float* db, int rows, int c,
                                       float slope, float scale, int vec, int tx,
                                       int ty, int gx, int gy, void* stream) {
  return launch_bwd(g, y, dx, part, db, rows, c, slope, scale, vec, tx, ty, gx,
                    gy, static_cast<cudaStream_t>(stream));
}

// The bf16 instances: every tensor bf16 but ``part`` (float32).
extern "C" int gk_fused_leaky_relu_bf16(const void* x, const void* bias,
                                        const void* m, void* y, int rows, int c,
                                        float slope, float scale, int vec,
                                        int tx, int ty, int gx, int gy,
                                        void* stream) {
  return launch_fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(bias),
                    static_cast<const bf16*>(m), static_cast<bf16*>(y), rows, c,
                    slope, scale, vec, tx, ty, gx, gy,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int gk_fused_leaky_relu_bwd_bf16(const void* g, const void* y,
                                            void* dx, float* part, void* db,
                                            int rows, int c, float slope,
                                            float scale, int vec, int tx,
                                            int ty, int gx, int gy,
                                            void* stream) {
  return launch_bwd(static_cast<const bf16*>(g), static_cast<const bf16*>(y),
                    static_cast<bf16*>(dx), part, static_cast<bf16*>(db), rows,
                    c, slope, scale, vec, tx, ty, gx, gy,
                    static_cast<cudaStream_t>(stream));
}
