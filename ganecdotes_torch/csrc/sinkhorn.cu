// Streaming log-domain Sinkhorn-Knopp codes for SwAV.
//
// Replaces ganecdotes_tpu/ops/sinkhorn_pallas.py::sinkhorn_knopp_pallas
// (the pallas_calls of _fused_kernel at :277, _u_kernel at :315 and
// _t_kernel at :340), in the schedule of its fused variant. Scores x (B, K)
// row-major fp32, marginals r (K,) and c (B,). With inv_eps = 1/eps:
//   u_k = log r_k - lse_b(x_bk * inv_eps + v_b)     (column log-sum-exp)
//   t_b = lse_k(x_bk * inv_eps + u_k),  v_b = log c_b - t_b   (row)
// and the codes are q_bk = exp(x_bk * inv_eps + u_k - t_b). The reference's
// global pre-normalisation shifts u and cancels in q, so it is never
// computed.
//
// Bound: bytes. The least traffic is niters + 1 reads of the B*K matrix and
// one write of q (at (20000, 5000), niters 10: 4.8 GB, 1.43 ms at
// 3.35 TB/s); 2 exps per element read. One pass over the matrix per
// iteration, each row read once from device memory:
//   pass 0:            column accumulators from v = 0 -> u_1;
//   pass i (1..N-1):   per row t_b from u_i, v_b = log c_b - t_b, then the
//                      row folded into the column accumulators -> u_{i+1};
//   last pass:         per row t_b from u_N, q written once.
// niters = 0 runs only the last pass with u = 0: the row softmax of
// x * inv_eps, as in the plain version.
//
// Design of a pass: one block of 512 threads per SM takes a contiguous
// chunk of rows and streams them through a double-buffered ring in shared
// memory, R rows a stage (as many as fit in 227 KB, at most 8). With
// K % 4 == 0 one thread issues a bulk copy (TMA) per row, awaited on the
// slot's mbarrier; a ragged K (rows not 16-byte aligned) takes 4-byte
// cp.async copies. Thread tid owns the float4 column groups 4 tid + 2048 j,
// j < J = ceil(K / 2048) <= 4 (so K <= 8192; the wrapper raises above), and
// keeps u and the (max, sum) column accumulators of its columns in
// registers. Each ring row is J * 2048 floats, the columns past K zero and
// their u the sentinel, so no loop over a row has a bound check: a padded
// column adds exp(-3e38 - max) = 0 to a row's sum. A stage's row
// log-sum-exps are computed by the whole block over those same columns:
// each thread's partial maxima, a block reduction, its partial sums of
// exp(z - max), a block reduction, the warps' shares merged in warp order.
// Then each thread folds the stage's rows into its column accumulators, the
// stage's max first (one rescale per column at most), then the rows' exps.
// Design notes, from an H100: with one block on an SM, latency is hidden by
// independent work in each thread. So every exp of a sum is independent of
// the others (an online max per element chains each exp to the last); the
// rows' loops run at run time over unguarded, unrolled column groups (a
// guard per group and row made each a basic block that waited on its own
// load); and the stage comes by TMA, not per-thread copies. The sums take
// the SFU's exp (ex2.approx.ftz of z * log2 e: ~2 ulp near the max, 0 below
// 2^-126); the codes take the accurate expf. At the chunk's end the block
// writes its partials; a combine kernel merges the chunks of each column
// in a fixed order into u. No atomics, and every reduction in a fixed
// order: the same codes from run to run. Maxima start at a finite sentinel
// (-3e38), never -inf, so empty lanes merge to exact zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInit = -3e38f;  // max start: below any finite z
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;           // rows a stage at most
constexpr int kSmemMax = 232448;      // bytes of shared memory a block may use
constexpr int kMaxGroups = 4;         // float4 column groups a thread
constexpr int kGroup = 4 * kThreads;  // columns of a group over the block
constexpr int kMaxK = kGroup * kMaxGroups;  // ops/sinkhorn.py MAX_K
constexpr int kRed = 2 * kWarps * kMaxRows;  // floats of the two reductions
constexpr int kHead = kRed + 4;  // then two 8-byte mbarriers, then the ring

enum Pass { kFirst, kMid, kLast };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// arm the barrier's phase for `bytes` of bulk copies
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` global -> shared by the bulk copy engine (TMA), completed on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// merge (m2, s2) into (m, s)
__device__ __forceinline__ void online_merge(float m2, float s2, float& m,
                                             float& s) {
  float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// e^x on the SFU: ex2.approx.ftz of x * log2(e); a result below 2^-126 is
// 0 (a term of a sum that far below its max)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// floats of a row in the ring: J whole groups, the columns past K zero
inline int row_pitch(int J) { return J * kGroup; }

// rows a stage: two stages in the shared memory beside the head
inline int stage_rows(int J) {
  const int r = (kSmemMax / 4 - kHead) / (2 * row_pitch(J));
  return r < kMaxRows ? r : kMaxRows;
}

// A row's value over the block, in a fixed order: a shuffle tree in each
// warp, whose lane 0 writes red[warp * kMaxRows]; after a barrier,
// block_value combines the 16 warps' shares in warp order (every thread
// gets the same bits).
template <bool MAX>
__device__ __forceinline__ void warp_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * kMaxRows] = v;
}

template <bool MAX>
__device__ __forceinline__ float block_value(const float* red) {
  float a = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    a = MAX ? fmaxf(a, red[w * kMaxRows]) : a + red[w * kMaxRows];
  return a;
}

// One pass over rows [chunk * rows, (chunk + 1) * rows) of x, R a stage.
// kFirst and kMid write the chunk's column partials; kLast writes q.
// Thread tid owns columns k = 4 tid + kGroup j + e, j < J, e < 4.
template <int J>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_pass(const float* __restrict__ x, const float* __restrict__ u,
              const float* __restrict__ c, float* __restrict__ part_m,
              float* __restrict__ part_s, float* __restrict__ q, int B, int K,
              int rows, int R, float inv_eps, int pass) {
  constexpr int P = J * kGroup;  // row pitch in the ring
  extern __shared__ __align__(16) float sm[];
  float* red_max = sm;                         // (kWarps, kMaxRows)
  float* red_sum = sm + kWarps * kMaxRows;     // (kWarps, kMaxRows)
  float* ring = sm + kHead;                    // (2, R, P)
  const uint32_t bar0 = smem_addr(sm + kRed);  // slot i's at bar0 + 8 i
  const int tid = threadIdx.x, lane = tid & 31;
  const int b0 = blockIdx.x * rows, b1 = min(B, b0 + rows);
  const bool vec = (K & 3) == 0;

  // this thread's columns: u (the sentinel past K) and the accumulators
  float uk[J][4], m[J][4], s[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = tid * 4 + j * kGroup + e;
      uk[j][e] = pass != kFirst && k < K ? u[k] : kNegInit;
      m[j][e] = kNegInit;
      s[j][e] = 0.f;
    }
  // the ring rows' columns past K stay 0: x / eps + u there is the sentinel
  for (int i = tid; i < 2 * R * (P - K); i += kThreads)
    ring[(i / (P - K)) * P + K + i % (P - K)] = 0.f;

  // Stage st goes to ring slot st & 1. With K % 4 == 0 one thread issues a
  // bulk copy (TMA) per row, awaited on the slot's mbarrier; per-thread
  // copies (cp.async), kept for a ragged K whose rows are not 16-byte
  // aligned, take issue slots and queue beside the shared-memory loads.
  if (vec && tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int st) {
    const int r0 = b0 + st * R, nr = min(R, b1 - r0);
    float* dst = ring + (st & 1) * R * P;
    if (vec) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (st & 1);
        expect_bytes(bar, nr * K * 4);
        for (int r = 0; r < nr; ++r)
          bulk_load(smem_addr(dst + r * P), x + (int64_t)(r0 + r) * K, K * 4,
                    bar);
      }
      return;
    }
    for (int r = 0; r < nr; ++r)
      for (int k = tid; k < K; k += kThreads)
        cp_async4(smem_addr(dst + r * P + k), x + (int64_t)(r0 + r) * K + k);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int nst = b1 > b0 ? (b1 - b0 + R - 1) / R : 0;
  if (nst > 0) load(0);
  for (int st = 0; st < nst; ++st) {
    if (vec)
      mbar_wait(bar0 + 8 * (st & 1), (st >> 1) & 1);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // stage st landed; everyone is done with stage st - 1
    if (st + 1 < nst) load(st + 1);
    const float* rows_s = ring + (st & 1) * R * P + tid * 4;
    const int r0 = b0 + st * R, nr = min(R, b1 - r0);

    // t_b of each row over the block: the max of z = x / eps + u, then the
    // sum of exp(z - max). Lane r of every warp then holds row r's max and
    // t_b (or v_b), and the row loops take them by shuffle.
    float row_max = 0.f, row_t = 0.f;
    if (pass != kFirst) {
      for (int r = 0; r < nr; ++r) {
        float mx = kNegInit;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(rows_s + r * P + j * kGroup);
          mx = fmaxf(fmaxf(mx, fmaxf(fmaf(xv.x, inv_eps, uk[j][0]),
                                     fmaf(xv.y, inv_eps, uk[j][1]))),
                     fmaxf(fmaf(xv.z, inv_eps, uk[j][2]),
                           fmaf(xv.w, inv_eps, uk[j][3])));
        }
        warp_reduce<true>(mx, red_max + r);
      }
      __syncthreads();
      if (lane < nr) row_max = block_value<true>(red_max + lane);
      for (int r = 0; r < nr; ++r) {
        const float mr = __shfl_sync(0xffffffffu, row_max, r);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(rows_s + r * P + j * kGroup);
          sum += (exp_sfu(fmaf(xv.x, inv_eps, uk[j][0]) - mr) +
                  exp_sfu(fmaf(xv.y, inv_eps, uk[j][1]) - mr)) +
                 (exp_sfu(fmaf(xv.z, inv_eps, uk[j][2]) - mr) +
                  exp_sfu(fmaf(xv.w, inv_eps, uk[j][3]) - mr));
        }
        warp_reduce<false>(sum, red_sum + r);
      }
      __syncthreads();
      if (lane < nr) {
        row_t = row_max + logf(block_value<false>(red_sum + lane));
        if (pass == kMid) row_t = logf(c[r0 + lane]) - row_t;  // v_b
      }
    }

    if (pass == kLast) {  // q from u_N and t_b, written once
      for (int r = 0; r < nr; ++r) {
        const float t = __shfl_sync(0xffffffffu, row_t, r);
        float* qrow = q + (int64_t)(r0 + r) * K;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = tid * 4 + j * kGroup;
          const float4 xv =
              *reinterpret_cast<const float4*>(rows_s + r * P + j * kGroup);
          const float o[4] = {expf(fmaf(xv.x, inv_eps, uk[j][0]) - t),
                              expf(fmaf(xv.y, inv_eps, uk[j][1]) - t),
                              expf(fmaf(xv.z, inv_eps, uk[j][2]) - t),
                              expf(fmaf(xv.w, inv_eps, uk[j][3]) - t)};
          if (vec) {
            if (k < K)
              *reinterpret_cast<float4*>(qrow + k) =
                  make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k + e < K) qrow[k + e] = o[e];
          }
        }
      }
      continue;
    }

    // fold the stage's rows into the column accumulators, z = x / eps + v_b:
    // the stage's max per column first (one rescale at most), then the
    // rows' exps, independent of each other
    float cm[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[j][e] = kNegInit;
    for (int r = 0; r < nr; ++r) {
      const float v = __shfl_sync(0xffffffffu, row_t, r);  // 0 in pass 0
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 xv =
            *reinterpret_cast<const float4*>(rows_s + r * P + j * kGroup);
        cm[j][0] = fmaxf(cm[j][0], fmaf(xv.x, inv_eps, v));
        cm[j][1] = fmaxf(cm[j][1], fmaf(xv.y, inv_eps, v));
        cm[j][2] = fmaxf(cm[j][2], fmaf(xv.z, inv_eps, v));
        cm[j][3] = fmaxf(cm[j][3], fmaf(xv.w, inv_eps, v));
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (cm[j][e] > m[j][e]) {
          s[j][e] *= exp_sfu(m[j][e] - cm[j][e]);
          m[j][e] = cm[j][e];
        }
    for (int r = 0; r < nr; ++r) {
      const float v = __shfl_sync(0xffffffffu, row_t, r);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 xv =
            *reinterpret_cast<const float4*>(rows_s + r * P + j * kGroup);
        s[j][0] += exp_sfu(fmaf(xv.x, inv_eps, v) - m[j][0]);
        s[j][1] += exp_sfu(fmaf(xv.y, inv_eps, v) - m[j][1]);
        s[j][2] += exp_sfu(fmaf(xv.z, inv_eps, v) - m[j][2]);
        s[j][3] += exp_sfu(fmaf(xv.w, inv_eps, v) - m[j][3]);
      }
    }
  }

  if (pass == kLast) return;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = tid * 4 + j * kGroup + e;
      if (k < K) {
        part_m[(int64_t)blockIdx.x * K + k] = m[j][e];
        part_s[(int64_t)blockIdx.x * K + k] = s[j][e];
      }
    }
}

// u_k = log r_k - lse over the chunks' partials. A block takes 32 columns;
// each of its kWarps warps merges every kWarps-th chunk, then warp 0 merges
// the kWarps results in warp order: a fixed order for every column.
__global__ void sinkhorn_col_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_s,
                                     const float* __restrict__ r,
                                     float* __restrict__ u, int K,
                                     int nchunks) {
  __shared__ float pm[kWarps][32], ps[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * 32 + lane;
  float m = kNegInit, s = 0.f;
  if (k < K)
    for (int ch = warp; ch < nchunks; ch += kWarps)
      online_merge(part_m[(int64_t)ch * K + k], part_s[(int64_t)ch * K + k],
                   m, s);
  pm[warp][lane] = m;
  ps[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || k >= K) return;
  for (int w = 1; w < kWarps; ++w) online_merge(pm[w][lane], ps[w][lane], m, s);
  u[k] = logf(r[k]) - (m + logf(s));
}

template <int J>
int run(const float* x, const float* r, const float* c, float* q, float* u,
        float* part_m, float* part_s, int B, int K, int niters, float inv_eps,
        int rows, int nchunks, cudaStream_t st) {
  const int R = stage_rows(J);
  const int smem = (kHead + 2 * R * row_pitch(J)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_pass<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  auto pass = [&](int kind) {
    sinkhorn_pass<J><<<nchunks, kThreads, smem, st>>>(
        x, u, c, part_m, part_s, q, B, K, rows, R, inv_eps, kind);
  };
  auto combine = [&]() {
    sinkhorn_col_combine<<<(K + 31) / 32, kThreads, 0, st>>>(part_m, part_s,
                                                             r, u, K, nchunks);
  };
  if (niters == 0) {  // the last pass alone, with u = 0
    err = cudaMemsetAsync(u, 0, sizeof(float) * K, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    pass(kFirst);
    combine();
    for (int it = 1; it < niters; ++it) {
      pass(kMid);
      combine();
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  pass(kLast);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, K) codes; u (K,) and the (nchunks, K) partials are scratch the
// caller allocates; chunk i is rows [i * rows, (i + 1) * rows), none empty.
extern "C" int gk_sinkhorn_knopp(const float* x, const float* r,
                                 const float* c, float* q, float* u,
                                 float* part_m, float* part_s, int B, int K,
                                 int niters, float inv_eps, int rows,
                                 int nchunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || B < 1 || rows < 1 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  switch ((K + kGroup - 1) / kGroup) {  // J, the column groups a thread
    case 1:
      return run<1>(x, r, c, q, u, part_m, part_s, B, K, niters, inv_eps,
                    rows, nchunks, st);
    case 2:
      return run<2>(x, r, c, q, u, part_m, part_s, B, K, niters, inv_eps,
                    rows, nchunks, st);
    case 3:
      return run<3>(x, r, c, q, u, part_m, part_s, B, K, niters, inv_eps,
                    rows, nchunks, st);
    default:
      return run<4>(x, r, c, q, u, part_m, part_s, B, K, niters, inv_eps,
                    rows, nchunks, st);
  }
}
