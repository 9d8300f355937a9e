// Streaming log-domain Sinkhorn-Knopp codes for SwAV.
//
// Replaces ganecdotes_tpu/ops/sinkhorn_pallas.py::sinkhorn_knopp_pallas
// (the pallas_calls of _fused_kernel at :277, _u_kernel at :315 and
// _t_kernel at :340). Scores x (B, K) row-major fp32, marginals r (K,) and
// c (B,). With inv_eps = 1/eps and v = 0 at the start, each iteration runs
//   u_k = log r_k - lse_b(x_bk * inv_eps + v_b)     (column pass + combine)
//   t_b = lse_k(x_bk * inv_eps + u_k),  v_b = log c_b - t_b   (row pass)
// and the codes are q_bk = exp(x_bk * inv_eps + u_k - t_b) (final pass).
// The reference's global pre-normalisation shifts u and cancels in q, so it
// is never computed. niters = 0 runs one row pass with u = 0 (q is then the
// row softmax of x * inv_eps, as in the plain version).
//
// Bound: bytes. The least traffic is niters + 1 reads of the B*K matrix and
// one write of q (at (20000, 5000), niters 10: 4.8 GB, 1.43 ms at
// 3.35 TB/s); there is about one exp per element read, far below the SFU
// rate. This first version makes 2*niters + 1 reads, one per update.
// Design:
// * every log-sum-exp is one streaming pass with an online max; the
//   accumulators start at a finite sentinel (-3e38), never -inf, so empty
//   lanes and chunks merge to exact zeros;
// * row pass and final pass: one warp per row, 16-byte loads when K % 4 == 0
//   (the wrapper checks that x is 16-byte aligned), else scalar loads;
// * column pass: blocks cannot carry an accumulator from one grid step to
//   the next on this card, so each block streams a chunk of rows for 256*VEC
//   columns and writes its (max, sum) partials; a combine kernel merges the
//   chunks of each column in a fixed order into u. No atomics: the codes are
//   the same from run to run.
// The ragged edges (the last column tile, the last row chunk) are masked in
// the kernels; no padded copy of x is made.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInit = -3e38f;  // online-max start: below any finite z
constexpr int kColThreads = 256;
constexpr int kRowWarps = 8;

// fold z into the running (m, s) with one exp
__device__ __forceinline__ void online_add(float z, float& m, float& s) {
  if (z > m) {
    s = s * expf(m - z) + 1.f;
    m = z;
  } else {
    s += expf(z - m);
  }
}

// merge (m2, s2) into (m, s)
__device__ __forceinline__ void online_merge(float m2, float s2, float& m,
                                             float& s) {
  float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Partial column log-sum-exp over rows [chunk*rows, (chunk+1)*rows) for the
// VEC columns of each thread. v holds the last row pass's potentials; with
// first != 0, v = 0.
template <int VEC>
__global__ void sinkhorn_col_partial(const float* __restrict__ x,
                                     const float* __restrict__ v_in,
                                     float* __restrict__ part_m,
                                     float* __restrict__ part_s, int B, int K,
                                     int rows, float inv_eps, int first) {
  const int col = (blockIdx.x * kColThreads + threadIdx.x) * VEC;
  const int chunk = blockIdx.y;
  const int b0 = chunk * rows;
  const int b1 = min(B, b0 + rows);
  if (col >= K) return;
  float m[VEC], s[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = kNegInit;
    s[j] = 0.f;
  }
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    const float v = first ? 0.f : __ldg(v_in + b);
    const float* row = x + (int64_t)b * K + col;
    if (VEC == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row));
      online_add(fmaf(q.x, inv_eps, v), m[0], s[0]);
      online_add(fmaf(q.y, inv_eps, v), m[1], s[1]);
      online_add(fmaf(q.z, inv_eps, v), m[2], s[2]);
      online_add(fmaf(q.w, inv_eps, v), m[3], s[3]);
    } else {
      online_add(fmaf(__ldg(row), inv_eps, v), m[0], s[0]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    part_m[(int64_t)chunk * K + col + j] = m[j];
    part_s[(int64_t)chunk * K + col + j] = s[j];
  }
}

// u_k = log r_k - lse over the chunks' partials, merged in chunk order.
__global__ void sinkhorn_col_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_s,
                                     const float* __restrict__ r,
                                     float* __restrict__ u, int K,
                                     int nchunks) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float m = kNegInit, s = 0.f;
  for (int ch = 0; ch < nchunks; ++ch)
    online_merge(part_m[(int64_t)ch * K + k], part_s[(int64_t)ch * K + k], m,
                 s);
  u[k] = logf(r[k]) - (m + logf(s));
}

// One warp per row b: t_b = lse_k(x_bk * inv_eps + u_k), v_b = log c_b -
// t_b. With write_q the row's codes q_bk = exp(x_bk * inv_eps + u_k - t_b)
// are written instead, using the t of the last row pass.
template <int VEC>
__global__ void sinkhorn_rows(const float* __restrict__ x,
                              const float* __restrict__ u,
                              const float* __restrict__ c,
                              float* __restrict__ t, float* __restrict__ v,
                              float* __restrict__ q, int B, int K,
                              float inv_eps, int write_q) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* row = x + (int64_t)b * K;
  if (write_q) {
    const float tb = t[b];
    float* qrow = q + (int64_t)b * K;
    if (VEC == 4) {
      for (int k = lane * 4; k < K; k += 128) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(row + k));
        const float4 uv = __ldg(reinterpret_cast<const float4*>(u + k));
        float4 o;
        o.x = expf(fmaf(xv.x, inv_eps, uv.x) - tb);
        o.y = expf(fmaf(xv.y, inv_eps, uv.y) - tb);
        o.z = expf(fmaf(xv.z, inv_eps, uv.z) - tb);
        o.w = expf(fmaf(xv.w, inv_eps, uv.w) - tb);
        *reinterpret_cast<float4*>(qrow + k) = o;
      }
    } else {
      for (int k = lane; k < K; k += 32)
        qrow[k] = expf(fmaf(__ldg(row + k), inv_eps, __ldg(u + k)) - tb);
    }
    return;
  }
  float m = kNegInit, s = 0.f;
  if (VEC == 4) {
    for (int k = lane * 4; k < K; k += 128) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(row + k));
      const float4 uv = __ldg(reinterpret_cast<const float4*>(u + k));
      online_add(fmaf(xv.x, inv_eps, uv.x), m, s);
      online_add(fmaf(xv.y, inv_eps, uv.y), m, s);
      online_add(fmaf(xv.z, inv_eps, uv.z), m, s);
      online_add(fmaf(xv.w, inv_eps, uv.w), m, s);
    }
  } else {
    for (int k = lane; k < K; k += 32)
      online_add(fmaf(__ldg(row + k), inv_eps, __ldg(u + k)), m, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    online_merge(m2, s2, m, s);
  }
  if (lane == 0) {
    const float tb = m + logf(s);
    t[b] = tb;
    v[b] = logf(c[b]) - tb;
  }
}

template <int VEC>
int run(const float* x, const float* r, const float* c, float* q, float* u,
        float* t, float* v, float* part_m, float* part_s, int B, int K,
        int niters, float inv_eps, int rows, int nchunks, cudaStream_t st) {
  const dim3 col_grid((K + kColThreads * VEC - 1) / (kColThreads * VEC),
                      nchunks);
  const int comb_blocks = (K + 255) / 256;
  const int row_blocks = (B + kRowWarps - 1) / kRowWarps;
  const int row_threads = 32 * kRowWarps;
  cudaError_t err;
  if (niters == 0) {
    err = cudaMemsetAsync(u, 0, sizeof(float) * K, st);
    if (err != cudaSuccess) return (int)err;
    sinkhorn_rows<VEC><<<row_blocks, row_threads, 0, st>>>(
        x, u, c, t, v, q, B, K, inv_eps, 0);
  }
  for (int it = 0; it < niters; ++it) {
    sinkhorn_col_partial<VEC><<<col_grid, kColThreads, 0, st>>>(
        x, v, part_m, part_s, B, K, rows, inv_eps, it == 0);
    sinkhorn_col_combine<<<comb_blocks, 256, 0, st>>>(part_m, part_s, r, u, K,
                                                      nchunks);
    sinkhorn_rows<VEC><<<row_blocks, row_threads, 0, st>>>(
        x, u, c, t, v, q, B, K, inv_eps, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sinkhorn_rows<VEC><<<row_blocks, row_threads, 0, st>>>(
      x, u, c, t, v, q, B, K, inv_eps, 1);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, K) codes; u (K,), t (B,), v (B,) and the (nchunks, K) partials are
// scratch the caller allocates, with nchunks = ceil(B / rows).
extern "C" int gk_sinkhorn_knopp(const float* x, const float* r,
                                 const float* c, float* q, float* u, float* t,
                                 float* v, float* part_m, float* part_s,
                                 int B, int K, int niters, float inv_eps,
                                 int rows, int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 4 == 0)
    return run<4>(x, r, c, q, u, t, v, part_m, part_s, B, K, niters, inv_eps,
                  rows, nchunks, st);
  return run<1>(x, r, c, q, u, t, v, part_m, part_s, B, K, niters, inv_eps,
                rows, nchunks, st);
}
