// DPBalance budget kernels for NVIDIA Hopper (sm_90a).
//
// Hand-written replacements of the Pallas TPU kernels in
// src/repro/kernels/budget_alloc.py.  Plain C interface (loaded with ctypes
// by repro_torch/kernels/build.py): every entry point takes device pointers,
// the sizes and PyTorch's current stream, launches on that stream, does not
// synchronise or allocate, and returns cudaGetLastError() so a refused
// launch surfaces in the Python wrapper.
//
// Rounding contract (see repro_torch/kernels/ref.py): every a*b+c update
// the reference performs is one fused multiply-add (__fmaf_rn), exactly as
// XLA contracts it, and divisions are IEEE (never build with
// --use_fast_math).  rowmax, matvec_t, dual_step's g (given x) and the boost
// sweep are bitwise equal to their twins; matvec and dual_step's x use a
// tree sum over K and agree with their twins within 1e-5 relative, and are
// bitwise from launch to launch (every sum runs in a fixed order).
//
// rowmax and matvec (repro's rowmax and matvec, pallas_call at
// budget_alloc.py:47 and :81) read M*K*4 bytes once and do one or two
// operations per 4 bytes: bound by bytes.  One block per row left them
// bound by latency instead (M blocks on 132 SMs, one 4-byte load in flight
// a thread), so each row is split over a thread-block cluster of cs blocks
// (cs from repro_torch/kernels/budget_alloc.py:row_split): every block
// reads a contiguous chunk of the row with 16-byte loads, 4 (rowmax) or 8
// (matvec) of them in flight a thread, reduces it to one float, and stores
// it into block rank 0's shared memory (distributed shared memory); rank 0
// combines the cs partials in rank order.  One launch, no workspace, one
// exposed cluster barrier, a fixed combine order.
//
// A fleet of E episodes (repro's run_fleet(mode="vmap")) runs its SP1 in
// lockstep: matvec, matvec_t and dual_kernel's ascent take E stacked
// operands ([E, M, K], [E, K], ...) in one launch, and each episode's
// result is bitwise a lone launch's on its own operands (same cluster size,
// same order of every sum, whatever E is).  rowmax and the boost sweep take
// the fleet folded into their row axis (E*M rows) as they stand.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
// 16-byte loads in flight a thread, each kernel's depth picked on an H100
// from 2, 4 and 8.
constexpr int kUnrollMax = 4;                 // rowmax
constexpr int kUnrollDot = 8;                 // matvec
constexpr int kMaxCluster = 8;                // portable cluster size
constexpr float kNegInit = -1e30f;            // rowmax accumulator start
constexpr float kDualEps = 1e-12f;
constexpr float kBoostEps = 1e-9f;

struct MaxOp {
  __device__ static float id() { return -INFINITY; }
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};
struct SumOp {
  __device__ static float id() { return 0.0f; }
  __device__ static float op(float a, float b) { return a + b; }
};

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide reduction; every thread gets the result.  `sh` holds 32
// floats.  Ends with a barrier so `sh` can be reused by the next call.
template <typename Op>
__device__ float block_reduce(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : Op::id();
  if (wid == 0) v = warp_reduce<Op>(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  const float r = sh[0];
  __syncthreads();
  return r;
}

// ------------------------------------------------- rowmax and matvec
// The cs blocks of a row's cluster split it on the row's own 16-byte grid:
// h scalars up to the first 16-byte boundary (block 0), nvec float4s cut
// into cs balanced runs of whole vectors, and the scalar tail (block cs -
// 1).  Every element is read exactly once.
struct RowChunk {
  int h, nvec, v0, v1;        // head length, float4s in the row, own run
};

// The chunks of a row whose head (the scalars before its first 16-byte
// boundary) is h floats long.
__device__ __forceinline__ RowChunk row_chunk_at(int h, int K, int rank,
                                                 int cs) {
  RowChunk c;
  c.h = h > K ? K : h;
  c.nvec = (K - c.h) >> 2;
  c.v0 = (int)((long long)rank * c.nvec / cs);
  c.v1 = (int)((long long)(rank + 1) * c.nvec / cs);
  return c;
}

__device__ __forceinline__ RowChunk row_chunk(const float* row, int K,
                                              int rank, int cs) {
  return row_chunk_at(
      (int)((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) >> 2, K, rank,
      cs);
}

// A split row's cluster meets twice at a hardware cluster barrier.  Every
// block arrives (relaxed) as it starts, and waits on that phase only
// before its first remote store, so the wait costs nothing by then; the
// second phase publishes the stores to block rank 0.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every thread passes its block's reduced value v (the same in all
// threads).  With cs > 1 (the block arrived at the cluster barrier when
// it started), each block stores v into parts[rank] of block rank 0's
// shared memory (distributed shared memory), the cluster syncs, and rank
// 0 combines parts[0..cs-1] in rank order and writes *dst.  Only rank 0's
// shared memory is read remotely, and rank 0 outlives every store to it.
template <typename Op>
__device__ void cluster_combine(float v, float* parts, float* dst) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks();
  if (cs == 1) {
    if (threadIdx.x == 0) *dst = v;
    return;
  }
  const unsigned rank = cluster.block_rank();
  cluster_wait();                          // every block of the cluster runs
  if (threadIdx.x == 0) cluster.map_shared_rank(parts, 0)[rank] = v;
  cluster.sync();                          // release the stores to rank 0
  if (rank == 0 && threadIdx.x == 0) {
    float r = parts[0];
    for (unsigned q = 1; q < cs; ++q) r = Op::op(r, parts[q]);
    *dst = r;
  }
}

// mu_i = max_k g_ik.  Grid: cs * M blocks in clusters of cs, row i on
// blocks i*cs .. i*cs + cs - 1.  fmaxf from kNegInit (the TPU kernel's
// NEG_INF), warp shuffle, block reduce, cluster combine: max is
// order-free, so bitwise equal to amax.
__global__ void rowmax_kernel(const float* __restrict__ g,
                              float* __restrict__ out, int K) {
  __shared__ float sh[32];
  __shared__ float parts[kMaxCluster];
  const int cs = (int)cg::this_cluster().num_blocks();
  if (cs > 1) cluster_arrive_relaxed();
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t i = blockIdx.x / cs;
  const float* row = g + i * K;
  const RowChunk c = row_chunk(row, K, rank, cs);
  const float4* rv = reinterpret_cast<const float4*>(row + c.h);
  const int t = threadIdx.x;
  float m = kNegInit;
  for (int j = c.v0 + t; j < c.v1; j += kUnrollMax * kThreads) {
    float4 a[kUnrollMax];
#pragma unroll
    for (int u = 0; u < kUnrollMax; ++u)
      a[u] = j + u * kThreads < c.v1
                 ? __ldg(rv + j + u * kThreads)
                 : make_float4(kNegInit, kNegInit, kNegInit, kNegInit);
#pragma unroll
    for (int u = 0; u < kUnrollMax; ++u)
      m = fmaxf(fmaxf(m, a[u].x),
                fmaxf(fmaxf(a[u].y, a[u].z), a[u].w));
  }
  if (rank == 0 && t < c.h) m = fmaxf(m, row[t]);
  const int k_tail = c.h + 4 * c.nvec + t;
  if (rank == cs - 1 && k_tail < K) m = fmaxf(m, row[k_tail]);
  m = block_reduce<MaxOp>(m, sh);
  cluster_combine<MaxOp>(m, parts, out + i);
}

// acc += sum over float4s j in [v0, v1) of c4[j] . v at the same elements,
// one __fmaf_rn per element, in order.  c4 and v4 are c and v at the run's
// first element; kVecC and kVecV say whether each is 16-byte aligned (else
// it is read as scalars: the same elements, the same FMAs).  v is shared by
// all rows of an episode and comes from L2.
template <bool kVecC, bool kVecV>
__device__ __forceinline__ float dot_run(const float* __restrict__ c4,
                                         const float* __restrict__ v4,
                                         int v0, int v1, float acc) {
  for (int j = v0 + (int)threadIdx.x; j < v1; j += kUnrollDot * kThreads) {
    float4 a[kUnrollDot], b[kUnrollDot];
#pragma unroll
    for (int u = 0; u < kUnrollDot; ++u) {
      const int jj = j + u * kThreads;
      a[u] = b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (jj < v1) {
        if constexpr (kVecC)
          a[u] = __ldg(reinterpret_cast<const float4*>(c4) + jj);
        else
          a[u] = make_float4(__ldg(c4 + 4 * jj), __ldg(c4 + 4 * jj + 1),
                             __ldg(c4 + 4 * jj + 2), __ldg(c4 + 4 * jj + 3));
        if constexpr (kVecV)
          b[u] = __ldg(reinterpret_cast<const float4*>(v4) + jj);
        else
          b[u] = make_float4(__ldg(v4 + 4 * jj), __ldg(v4 + 4 * jj + 1),
                             __ldg(v4 + 4 * jj + 2), __ldg(v4 + 4 * jj + 3));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollDot; ++u) {
      if (j + u * kThreads < v1) {
        acc = __fmaf_rn(a[u].x, b[u].x, acc);
        acc = __fmaf_rn(a[u].y, b[u].y, acc);
        acc = __fmaf_rn(a[u].z, b[u].z, acc);
        acc = __fmaf_rn(a[u].w, b[u].w, acc);
      }
    }
  }
  return acc;
}

// y_i = sum_k c_ik v_k for the E*M rows of a fleet, row i of episode i / M
// reading that episode's v.  Grid as rowmax_kernel's.  A row is cut on its
// episode's own 16-byte grid (its head is the floats before the next
// multiple of 4 counted from the episode's first element), so the chunks
// and every sum's order depend on (M, K, cs) alone: an episode's y is
// bitwise a lone launch's on its operands, wherever they sit.  Per thread
// an FMA chain over its elements (head, its float4s, tail), then warp and
// block tree sums, then the cs partials added in rank order: within 1e-5
// relative of the twin.
__global__ void matvec_kernel(const float* __restrict__ c,
                              const float* __restrict__ v,
                              float* __restrict__ y, int M, int K) {
  __shared__ float sh[32];
  __shared__ float parts[kMaxCluster];
  const int cs = (int)cg::this_cluster().num_blocks();
  if (cs > 1) cluster_arrive_relaxed();
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t i = blockIdx.x / cs;
  const size_t e = i / M, il = i - e * M;
  const float* row = c + i * K;
  const float* ve = v + e * K;
  const RowChunk ch = row_chunk_at((int)((4 - (il * K & 3)) & 3), K, rank,
                                   cs);
  const float* c4 = row + ch.h;
  const float* v4 = ve + ch.h;
  const bool vec_c = (reinterpret_cast<size_t>(c4) & 15) == 0;
  const bool vec_v = (reinterpret_cast<size_t>(v4) & 15) == 0;
  const int t = threadIdx.x;
  float acc = 0.0f;
  if (rank == 0 && t < ch.h) acc = __fmaf_rn(row[t], ve[t], acc);
  if (vec_c)
    acc = vec_v ? dot_run<true, true>(c4, v4, ch.v0, ch.v1, acc)
                : dot_run<true, false>(c4, v4, ch.v0, ch.v1, acc);
  else
    acc = vec_v ? dot_run<false, true>(c4, v4, ch.v0, ch.v1, acc)
                : dot_run<false, false>(c4, v4, ch.v0, ch.v1, acc);
  const int k_tail = ch.h + 4 * ch.nvec + t;
  if (rank == cs - 1 && k_tail < K)
    acc = __fmaf_rn(row[k_tail], ve[k_tail], acc);
  acc = block_reduce<SumOp>(acc, sh);
  cluster_combine<SumOp>(acc, parts, y + i);
}

// load_k = sum_i c_ik x_i: one thread per column k, rows 0..M-1 in order,
// one FMA each.  Neighbouring threads read neighbouring columns of a row,
// so every load is coalesced and no transpose is materialised.  Grid y is
// the episode of a fleet: its c, x and load lie E-strided.
__global__ void matvec_t_kernel(const float* __restrict__ c,
                                const float* __restrict__ x,
                                float* __restrict__ load, int M, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t e = blockIdx.y;
  c += e * M * K;
  x += e * M;
  load += e * K;
  float acc = 0.0f;
  for (int i = 0; i < M; ++i) acc = __fmaf_rn(c[(size_t)i * K + k], x[i], acc);
  load[k] = acc;
}

// ------------------------------------------------------------- dual_step
// repro's dual_step (pallas_call at budget_alloc.py:165) is one SP1
// iteration, and repro runs the SP1 loop around it on the device, as a
// lax.while_loop whose stop rule never leaves the chip
// (repro/core/waterfill.py).  dual_kernel is one thread-block cluster of
// cs blocks (cs from repro_torch/kernels/budget_alloc.py:dual_split) that
// runs either one iteration (step mode: x and g out) or the whole loop with
// its stop rule (ascent mode: lam and the iteration count out), so an SP1
// solve is one launch with no host round trip.  Bound: not the card's
// rates (4*M*K operations an iteration) but the cluster's cs SMs alone:
// each iteration reads c (M*K*4 bytes, in L2 at the scheduler's sizes)
// twice from L2, which sets the time at M=32, K=16384, and at the paper's
// size the latency of those reads and of two cluster barriers does.
//
// One iteration:
//  1. Denominators.  Row i belongs to block rank i % cs.  A thread runs an
//     FMA chain over k = t, t + 256, ... and a block tree sum gives sum_k
//     c_ik lam_k in dual_step's original order (a block of 256 threads per
//     row), so x is bitwise what that order gives; kDualRows rows of a block
//     run interleaved.  x_i goes into every block's shared memory
//     (distributed shared memory).
//  2. Cluster barrier: x is everywhere, and every read of lam is done.
//  3. Load.  Block rank b owns the columns [4 floor(b Q / cs), 4 floor((b
//     + 1) Q / cs)), Q = ceil(K / 4); a thread sums c_ik x_i over rows
//     0..M-1 in order, one FMA each, for kDualCols columns at once, read 16
//     bytes at a time where the rows of c are 16-byte aligned (load_step);
//     g_k = (load_k - cap_k) / cap_safe_k, bitwise the twin's given x.
// Ascent mode goes on:
//  4. lam_k = clamp(lam_k exp(eta g_k), 1e-12, 1e12) on the block's own
//     columns, into the output (the input is read only in the first
//     iteration), and the block's part of the KKT error max(max(g, 0),
//     lam |g|), with NaN propagated as torch's clamp and amax propagate it.
//     Every block stores its part into every block's shared memory.
//  5. Cluster barrier.  It releases and acquires at cluster scope, so the
//     lam stripes written to global memory are seen by every block's next
//     step 1 (which reads lam through L2, never a stale L1 line).  Each
//     block combines the cs parts itself and applies the stop rule (it <
//     max_iters and viol > tol) and the step size: the same values and the
//     same code in every block, so the blocks stay in lockstep without a
//     broadcast or a third barrier.
// Remote stores into a block's shared memory happen only between barriers
// that the block takes part in, so no block exits while another still
// writes to it.
// A fleet's ascent is one launch of E such clusters, cluster e on episode
// e's operands (E-strided) with its own step, count and stop rule; no
// cluster reads another's memory, so each episode's lam and count are a
// lone launch's.  Clusters that do not fit on the card at once run in
// waves (ba_dual_max_clusters).
// Loads in flight a thread: kDualRows rows x kDualSteps columns in step 1,
// kDualLoadRows rows (half as many with 4-byte loads) x kDualCols columns
// in step 3; each depth the fastest tried on an H100.
constexpr int kDualRows = 4;
constexpr int kDualSteps = 8;
constexpr int kDualLoadRows = 8;
constexpr int kDualCols = 8;
constexpr float kLamMin = 1e-12f, kLamMax = 1e12f;
// x (M floats) lives in dynamic shared memory, at most this many bytes.
constexpr size_t kSmemXMax = 200 * 1024;

struct DualArgs {
  const float* c;
  const float* lam_in;
  const float* w_pow;
  const float* xcap;
  const int* mask;
  const float* cap;
  const float* cap_safe;
  float* x;           // step mode: x [M] and g [K]; null in ascent mode
  float* g;
  float* lam;         // ascent mode: lam [K] and the iteration count; null
  int* iters;         //   in step mode
  int M, K;           // one episode's rows and columns
  float inv_beta;
  int max_iters;
  float tol;
  int adaptive;
};

// max and clamp that return NaN when an operand is NaN (torch.amax,
// torch.maximum and torch.clamp do; fmaxf and fminf drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
struct NanMaxOp {
  __device__ static float id() { return -INFINITY; }
  __device__ static float op(float a, float b) { return nan_max(a, b); }
};

// A barrier over the cluster (one block: over the block) that releases
// every thread's earlier stores, global and shared, and acquires them.
__device__ __forceinline__ void cluster_barrier(int cs) {
  if (cs > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// v[r] = block_reduce<SumOp>(v[r]) for r < n <= R at once: the same warp
// and block trees, so each row's sum is bitwise what block_reduce gives.
// The totals land in every thread of warp 0 (R <= 32).
template <int R>
__device__ void block_sum_rows(float (&v)[R], int n, float (*sh)[32]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n) break;
    v[r] = warp_reduce<SumOp>(v[r]);
    if (lane == 0) sh[r][wid] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n) break;
    v[r] = (threadIdx.x < nwarps) ? sh[r][threadIdx.x] : SumOp::id();
    if (wid == 0) v[r] = warp_reduce<SumOp>(v[r]);
  }
  __syncthreads();
}

// Steps 3 and 4 on this block's columns [k0, k1) (multiples of 4 apart
// from K): a thread takes kDualCols columns a pass, as two quads of 4
// adjacent columns read with 16-byte loads where every row of c is 16-byte
// aligned (kVec), else as columns 256 apart read one float at a time.  Rows
// in order, kRows of them loaded before their FMAs.  Writes g (step mode)
// or lam (ascent mode); returns the thread's part of the KKT error.
template <bool kVec>
__device__ __forceinline__ float load_step(const DualArgs& a,
                                           const float* xs,
                                           const float* lam_src, int k0,
                                           int k1, float eta) {
  constexpr int kRows = kVec ? kDualLoadRows : kDualLoadRows / 2;
  const int M = a.M, K = a.K;
  const bool ascent = a.lam != nullptr;
  float part = NanMaxOp::id();
  for (int kb = k0 + (kVec ? 4 : 1) * (int)threadIdx.x; kb < k1;
       kb += kDualCols * kThreads) {
    int col[kDualCols];
    float ld[kDualCols], cp[kDualCols], cps[kDualCols], lo[kDualCols];
#pragma unroll
    for (int j = 0; j < kDualCols; ++j) {        // the columns' own operands
      col[j] = kVec ? kb + (j / 4) * 4 * kThreads + j % 4 : kb + j * kThreads;
      const bool in = col[j] < k1;
      ld[j] = 0.0f;
      cp[j] = in ? a.cap[col[j]] : 0.0f;
      cps[j] = in ? a.cap_safe[col[j]] : 1.0f;
      lo[j] = (ascent && in) ? lam_src[col[j]] : 0.0f;
    }
    for (int i0 = 0; i0 < M; i0 += kRows) {
      float v[kRows][kDualCols], xi[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        const float* row = a.c + (size_t)i * K;
        xi[r] = i < M ? xs[i] : 0.0f;
        if constexpr (kVec) {
#pragma unroll
          for (int h = 0; h < kDualCols / 4; ++h) {
            const int k = col[4 * h];
            const float4 f = (i < M && k < k1)
                ? __ldg(reinterpret_cast<const float4*>(row + k))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            v[r][4 * h] = f.x;
            v[r][4 * h + 1] = f.y;
            v[r][4 * h + 2] = f.z;
            v[r][4 * h + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kDualCols; ++j)
            v[r][j] = (i < M && col[j] < k1) ? __ldg(row + col[j]) : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r >= M) break;
#pragma unroll
        for (int j = 0; j < kDualCols; ++j)
          ld[j] = __fmaf_rn(v[r][j], xi[r], ld[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kDualCols; ++j) {
      const int k = col[j];
      if (k >= k1) continue;
      const float gk = (ld[j] - cp[j]) / cps[j];
      if (!ascent) {
        a.g[k] = gk;
        continue;
      }
      const float step = eta * gk;
      const float ln = nan_clamp(lo[j] * expf(step), kLamMin, kLamMax);
      a.lam[k] = ln;
      const float feas = gk != gk ? gk : fmaxf(gk, 0.0f);
      part = nan_max(part, nan_max(feas, ln * fabsf(gk)));
    }
  }
  return part;
}

// Episode e's operands: every pointer moved past the e episodes before it.
__device__ __forceinline__ DualArgs episode_args(DualArgs a, size_t e) {
  const size_t M = a.M, K = a.K;
  a.c += e * M * K;
  a.lam_in += e * K;
  a.w_pow += e * M;
  a.xcap += e * M;
  a.mask += e * M;
  a.cap += e * K;
  a.cap_safe += e * K;
  if (a.x != nullptr) a.x += e * M;
  if (a.g != nullptr) a.g += e * K;
  if (a.lam != nullptr) a.lam += e * K;
  if (a.iters != nullptr) a.iters += e;
  return a;
}

__global__ void __launch_bounds__(kThreads)
dual_kernel(DualArgs fleet) {
  extern __shared__ float xs[];                  // x, all M rows
  __shared__ float sh[kDualRows][32];
  __shared__ float parts[kMaxCluster];           // the blocks' KKT parts
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const DualArgs a = episode_args(fleet, blockIdx.x / cs);
  const int t = threadIdx.x, M = a.M, K = a.K;
  // this block's columns [k0, k1): its share of the Q quads of 4 columns
  const int Q = (K + 3) / 4;
  const int k0 = 4 * (int)((long long)rank * Q / cs);
  const int k1 = min(4 * (int)((long long)(rank + 1) * Q / cs), K);
  const bool vec = K % 4 == 0 && (reinterpret_cast<size_t>(a.c) & 15) == 0;
  const bool ascent = a.lam != nullptr;
  if (ascent && a.max_iters <= 0) {              // no iteration: lam = lam0
    for (int k = k0 + t; k < k1; k += kThreads) a.lam[k] = a.lam_in[k];
    if (rank == 0 && t == 0) *a.iters = 0;
    return;
  }
  cluster_barrier(cs);                           // every block runs
  const float* lam_src = a.lam_in;
  int it = 0;
  float eta = 0.5f, viol_prev = INFINITY;
  for (;;) {
    if (ascent && !a.adaptive)                   // 0.5 / (1 + 0.001 it)
      eta = 0.5f / __fmaf_rn(0.001f, (float)it, 1.0f);
    // 1. denominators and x of this block's rows
    for (int i0 = rank; i0 < M; i0 += kDualRows * cs) {
      const int nr = min(kDualRows, (M - i0 + cs - 1) / cs);
      float acc[kDualRows];
#pragma unroll
      for (int r = 0; r < kDualRows; ++r) acc[r] = 0.0f;
      // kDualSteps of a thread's columns are loaded before their FMAs
      for (int kb = t; kb < K; kb += kDualSteps * kThreads) {
        float l[kDualSteps], v[kDualRows][kDualSteps];
#pragma unroll
        for (int u = 0; u < kDualSteps; ++u) {
          const int k = kb + u * kThreads;
          l[u] = k < K ? __ldcg(lam_src + k) : 0.0f;
#pragma unroll
          for (int r = 0; r < kDualRows; ++r)
            v[r][u] = (k < K && r < nr)
                          ? __ldg(a.c + (size_t)(i0 + r * cs) * K + k)
                          : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kDualSteps; ++u) {
          if (kb + u * kThreads >= K) break;
#pragma unroll
          for (int r = 0; r < kDualRows; ++r)
            acc[r] = __fmaf_rn(v[r][u], l[u], acc[r]);
        }
      }
      block_sum_rows<kDualRows>(acc, nr, sh);
#pragma unroll
      for (int r = 0; r < kDualRows; ++r) {
        if (t != r || r >= nr) continue;
        const int i = i0 + r * cs;
        const float denom = fmaxf(acc[r], kDualEps);
        float xi = powf(a.w_pow[i] / denom, a.inv_beta);
        xi = fminf(xi, a.xcap[i]);
        xi = a.mask[i] != 0 ? xi : 0.0f;
        for (int q = 0; q < cs; ++q) cluster.map_shared_rank(xs, q)[i] = xi;
        if (!ascent) a.x[i] = xi;
      }
    }
    // 2. x is in every block; lam is no longer read
    cluster_barrier(cs);
    // 3. load and g on this block's columns; 4. the update and the KKT part
    float part = vec ? load_step<true>(a, xs, lam_src, k0, k1, eta)
                     : load_step<false>(a, xs, lam_src, k0, k1, eta);
    if (!ascent) return;
    part = block_reduce<NanMaxOp>(part, sh[0]);
    if (t == 0)
      for (int q = 0; q < cs; ++q) cluster.map_shared_rank(parts, q)[rank] = part;
    // 5. lam and every block's part are published
    cluster_barrier(cs);
    float viol = parts[0];
    for (int q = 1; q < cs; ++q) viol = nan_max(viol, parts[q]);
    ++it;
    if (a.adaptive) {
      eta = viol <= viol_prev ? fminf(eta * 1.2f, 1.5f)
                              : fmaxf(eta * 0.7f, 0.2f);
      viol_prev = viol;
    }
    lam_src = a.lam;
    if (!(it < a.max_iters && viol > a.tol)) break;
  }
  if (rank == 0 && t == 0) *a.iters = it;
}

// ----------------------------------------------------------- boost sweep
// repro's boost_scan and swap_eval (pallas_call at budget_alloc.py:233 and
// :305) are one computation, the SP2 boost sweep: for each (analyst b,
// candidate c) a chain over the N visit-ordered demand rows g_j of b; a
// visit that c selects takes extra = clip(min over live k (g_jk > 1e-9) of
// left_k / g_jk, 0, kappa_max - 1) and debits left_k = fma(-extra, g_jk,
// left_k).  Bound: bytes -- the leftover stack M*C*K*4 (512 MB at M=32,
// C=256, K=16384) read once; the demand rows are shared by an analyst's
// candidates, and the work is one divide and one FMA per nonzero g_jk of
// a selected visit (rows are ~10% dense).  Yet each visit waits on the
// previous one's debit, so the time is that chain's latency times the
// visits, over the tiles an SM holds at once.  The first port (one block
// per candidate) streamed g_j from L2 twice a visit, one 4-byte load in
// flight a thread, and divided at every k.
//
// sweep_tile_kernel runs a tile of T candidates of one analyst (T = 1 for
// boost_scan; cs and T from repro_torch/kernels/budget_alloc.py:
// sweep_split) on a thread-block cluster of cs blocks.  Block rank r keeps
// the stripe [k0, k1) of the tile's T leftover rows in shared memory (in
// left_out when the stripes and lists would exceed kSweepSmemMax: the
// spill path).  Per visit that a candidate of the tile selects:
//  1. the block's stripe of g_j, loaded while the previous visit was
//     reduced (16-byte loads where the rows are aligned), is compacted by
//     each warp into a list of its nonzero entries in shared memory (a zero
//     entry is dead for the min, and its debit fma(-e, +0, l) is l);
//  2. each lane walks its warp's list for every selecting candidate: the
//     min of left / g over live entries; one redux.sync per warp; the
//     block's warps after one __syncthreads; and with cs > 1 warp i stores
//     candidate i's block minimum into every block of the cluster with
//     st.async, which completes bytes on the target's mbarrier, so no
//     cluster barrier (and no fence waiting on the loads in flight) is
//     taken.  min is order-free, so extra is bitwise the twin's;
//  3. the same list debits every selecting candidate, one __fmaf_rn each.
// A visit no candidate of the tile selects costs nothing.  A warp's list
// holds only the warp's own stripe elements, so the leftover is ordered by
// __syncwarp alone.  Measured and dropped on an H100 (PERF.md): a
// cluster barrier a visit, per-thread bit masks instead of the lists, every
// warp storing its own minimum, and finding the min by exact products in
// double before one divide.
constexpr int kWarps = kThreads / 32;
constexpr int kSweepTileMax = 8;             // candidates a tile (mask bits)
static_assert(kSweepTileMax <= kWarps, "one warp per candidate combines");
// Dynamic shared memory a sweep block may take: its T leftover stripes
// and its warps' lists.  Past it the leftover stays in left_out.
constexpr size_t kSweepSmemMax = 200 * 1024;

struct SweepArgs {
  const float* g_ord;       // [B, N, K] visit-ordered demand rows
  const int* sel;           // [B, C, N] selections (nonzero = selected)
  const float* left_in;     // [B, C, K] initial leftovers
  float* extras;            // [B, C, N]
  float* left_out;          // [B, C, K]; null: the leftover is dropped
  int C, N, K;
  int T, tiles;             // candidates a tile, tiles an analyst
  int ls;                   // floats of a candidate's stripe in smem
  float kappa_cap;
};

// Offset in the block's stripe of element w of float4 u of chunk ch of
// this thread: kVec, quads t, t + 256, ...; else floats t, t + 256, ...
// A chunk is 4 * V * kThreads floats; each warp owns fixed elements.
template <int V, bool kVec>
__device__ __forceinline__ int stripe_pos(int ch, int u, int w) {
  const int t = threadIdx.x;
  return kVec ? 4 * ((ch * V + u) * kThreads + t) + w
              : ((ch * V + u) * 4 + w) * kThreads + t;
}

// This thread's elements of chunk ch of the stripe g[0, L), 0 past L.
template <int V, bool kVec>
__device__ __forceinline__ void load_chunk(float4 (&d)[V],
                                           const float* __restrict__ g,
                                           int L, int ch) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if constexpr (kVec) {
      const int p = stripe_pos<V, true>(ch, u, 0);
      d[u] = p < L ? __ldg(reinterpret_cast<const float4*>(g + p))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      float v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int p = stripe_pos<V, false>(ch, u, w);
        v[w] = p < L ? __ldg(g + p) : 0.0f;
      }
      d[u] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The warp's nonzero elements of a loaded chunk as (stripe offset, g)
// pairs into its list; returns their count (the same in every lane).
template <int V, bool kVec>
__device__ __forceinline__ int compact(const float4 (&d)[V], float2* list,
                                       int ch) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int n = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float v[4] = {d[u].x, d[u].y, d[u].z, d[u].w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const bool nz = __float_as_uint(v[w]) != 0u;      // +0 only is skipped
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      if (nz)
        list[n + __popc(bal & below)] =
            make_float2(__int_as_float(stripe_pos<V, kVec>(ch, u, w)), v[w]);
      n += __popc(bal);
    }
  }
  return n;
}

// Copy L floats (16 bytes at a time with kVec: L % 4 == 0, both aligned).
template <bool kVec>
__device__ __forceinline__ void copy_stripe(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int L) {
  if constexpr (kVec) {
#pragma unroll 4
    for (int q = threadIdx.x; q < L / 4; q += kThreads)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(src)[q];
  } else {
#pragma unroll 4
    for (int k = threadIdx.x; k < L; k += kThreads) dst[k] = src[k];
  }
}

// The tile's visits in order, 32 at a time: lane l holds the selection
// bits (bit i: candidate i of the tile) of visit j0 + l.  Every warp of
// the cluster walks the same sequence; the block that writes extras
// stores 0 for every visit a candidate does not select.
struct VisitCursor {
  const int* sel;       // the tile's first selection row
  float* extras;        // the tile's first extras row, or null
  int N, nt, j0;
  unsigned bits, pending;

  __device__ void fill(int j) {
    const int lane = threadIdx.x & 31;
    j0 = j;
    bits = 0;
    if (j0 + lane < N)
      for (int i = 0; i < nt; ++i)
        bits |= (unsigned)(__ldg(sel + (size_t)i * N + j0 + lane) != 0) << i;
    pending = __ballot_sync(0xffffffffu, bits != 0);
    if (extras != nullptr && j0 + lane < N)
      for (int i = 0; i < nt; ++i)
        if (!((bits >> i) & 1u)) extras[(size_t)i * N + j0 + lane] = 0.0f;
  }

  // The next visit some candidate selects, and its bits; false at the end.
  __device__ bool next(int& j, unsigned& m) {
    while (pending == 0) {
      if (j0 + 32 >= N) return false;
      fill(j0 + 32);
    }
    const int p = __ffs(pending) - 1;
    pending &= pending - 1;
    j = j0 + p;
    m = __shfl_sync(0xffffffffu, bits, p);
    return true;
  }
};

// A block's minima reach every block of its cluster by st.async into
// distributed shared memory, each store completing bytes on the target
// block's mbarrier (no cluster barrier, so no fence waits on the loads in
// flight).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
      ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// A float as an int of the same order (for every non-NaN float, -0 below
// +0), so a warp's min is one redux.sync.
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o ^ ((o >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float min8(const float* v) {
  const float4 a = reinterpret_cast<const float4*>(v)[0];
  const float4 b = reinterpret_cast<const float4*>(v)[1];
  return fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)),
               fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
}
static_assert(kWarps == 8 && kMaxCluster == 8,
              "min8 combines one value a warp, or a block");

// Grid: B * tiles clusters of cs blocks; kSmem: the leftover stripes live
// in shared memory (else in left_out); V float4s a thread per chunk; kT,
// the tile's candidates rounded up to a power of two, bounds every loop
// over the tile.
template <int V, bool kVec, bool kSmem, int kT>
__global__ void __launch_bounds__(kThreads)
sweep_tile_kernel(SweepArgs a) {
  extern __shared__ float4 sweep_shared[];
  __shared__ __align__(16) float wpart[2][kT][kWarps];
  __shared__ __align__(16) float cpart[2][kT][kMaxCluster];
  __shared__ __align__(8) unsigned long long mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int N = a.N, K = a.K;
  const int tile = blockIdx.x / cs;
  const int b = tile / a.tiles, c0 = (tile % a.tiles) * a.T;
  const int nt = min(a.T, a.C - c0);                 // the tile's candidates
  const int Q = (K + 3) / 4;                         // this block's stripe
  const int k0 = 4 * (int)((long long)rank * Q / cs);
  const int L = max(min(4 * (int)((long long)(rank + 1) * Q / cs), K) - k0, 0);
  const size_t row0 = (size_t)b * a.C + c0;
  float* smem = reinterpret_cast<float*>(sweep_shared);
  float* left;                                       // candidate i's stripe
  size_t stride;                                     //   at left + i*stride
  if constexpr (kSmem) {
    left = smem;
    stride = (size_t)a.ls;
  } else {
    left = a.left_out + row0 * K + k0;
    stride = (size_t)K;
  }
  float2* list = reinterpret_cast<float2*>(
                     smem + (kSmem ? (size_t)a.T * a.ls : 0)) +
                 warp * (4 * V * 32);
  for (int i = 0; i < nt; ++i)
    copy_stripe<kVec>(left + i * stride, a.left_in + (row0 + i) * K + k0, L);
  if (cs > 1) {                     // ranks past cs stay +inf in min8
    for (int k = t; k < 2 * kT * kMaxCluster; k += kThreads)
      (&cpart[0][0][0])[k] = INFINITY;
    if (t == 0) {
      mbar_init(smem_u32(&mbar[0]));
      mbar_init(smem_u32(&mbar[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  cluster_barrier(cs);              // leftovers in place, every block runs
  unsigned parity = 0;              // bit b: the phase mbar[b] is in
  const float* g = a.g_ord + (size_t)b * N * K + k0;
  const int chunk = 4 * V * kThreads;
  const int nch = (L + chunk - 1) / chunk;
  VisitCursor vc{a.sel + row0 * N,
                 rank == 0 && warp == 0 ? a.extras + row0 * N : nullptr, N,
                 nt, 0, 0u, 0u};
  vc.fill(0);
  float4 d[V];
  int j;
  unsigned m;
  bool have = vc.next(j, m);
  if (have) load_chunk<V, kVec>(d, g + (size_t)j * K, L, 0);
  int buf = 0, n = 0;
  while (have) {
    const int jv = j;
    const unsigned mv = m;
    const float* gj = g + (size_t)jv * K;
    float mn[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) mn[i] = INFINITY;
    for (int ch = 0; ch < nch; ++ch) {
      if (ch > 0) load_chunk<V, kVec>(d, gj, L, ch);
      __syncwarp();                 // the list's last readers are done
      n = compact<V, kVec>(d, list, ch);
      __syncwarp();
      if (nch == 1) {               // the next visit's stripe, in flight
        have = vc.next(j, m);       //   while this one is reduced
        if (have) load_chunk<V, kVec>(d, g + (size_t)j * K, L, 0);
      }
      for (int e = lane; e < n; e += 32) {
        const float2 en = list[e];
        const int p = __float_as_int(en.x);
        const bool live = en.y > kBoostEps;
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          if (!((mv >> i) & 1u)) continue;
          const float r = live ? left[i * stride + p] / fmaxf(en.y, kBoostEps)
                               : INFINITY;
          mn[i] = fminf(mn[i], r);
        }
      }
    }
    // the tile's minima: warps, then the block, then the cluster
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (!((mv >> i) & 1u)) continue;
      const int v = __reduce_min_sync(0xffffffffu, ordered(mn[i]));
      if (lane == 0) wpart[buf][i][warp] = unordered(v);
    }
    __syncthreads();
    if (cs > 1) {                   // every block's minima into every block
      const unsigned bar = smem_u32(&mbar[buf]);
      if (t == 0) mbar_expect(bar, 4u * cs * __popc(mv));
      if (warp < kT && ((mv >> warp) & 1u) && lane < cs)
        st_async(map_rank(smem_u32(&cpart[buf][warp][rank]), lane),
                 min8(wpart[buf][warp]), map_rank(bar, lane));
      mbar_wait(bar, (parity >> buf) & 1u);
      parity ^= 1u << buf;
    }
    float ex[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      ex[i] = 0.0f;
      if (!((mv >> i) & 1u)) continue;
      const float v = min8(cs == 1 ? wpart[buf][i] : cpart[buf][i]);
      ex[i] = fminf(fmaxf(v, 0.0f), a.kappa_cap);
      if (rank == 0 && t == i) a.extras[(row0 + i) * N + jv] = ex[i];
    }
    buf ^= 1;
    // the debit, chunk by chunk (a stripe of one chunk keeps its list)
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) {
        load_chunk<V, kVec>(d, gj, L, ch);
        __syncwarp();
        n = compact<V, kVec>(d, list, ch);
        __syncwarp();
      }
      for (int e = lane; e < n; e += 32) {
        const float2 en = list[e];
        const int p = __float_as_int(en.x);
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          if (!((mv >> i) & 1u)) continue;
          float* q = left + i * stride + p;
          *q = __fmaf_rn(-ex[i], en.y, *q);
        }
      }
    }
    if (nch != 1) {
      have = vc.next(j, m);
      if (have) load_chunk<V, kVec>(d, g + (size_t)j * K, L, 0);
    }
  }
  if constexpr (kSmem) {
    if (a.left_out != nullptr) {
      __syncthreads();
      for (int i = 0; i < nt; ++i)
        copy_stripe<kVec>(a.left_out + (row0 + i) * K + k0, left + i * stride,
                          L);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Launch `kernel(args...)` on a 1-D grid of `blocks` blocks in clusters
// of cs (cudaLaunchAttributeClusterDimension; 1, 2, 4 or 8, the portable
// sizes) with `smem` bytes of dynamic shared memory.  Returns the launch's
// cudaError_t, cleared so the next launch does not see it.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), long long blocks, int cs,
                    size_t smem, cudaStream_t stream, Args... args) {
  if (cs != 1 && cs != 2 && cs != 4 && cs != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (blocks <= 0) return (int)cudaGetLastError();
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();                  // clear it for the next launch
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// E clusters of cs blocks running dual_kernel, one an episode, x in M * 4
// bytes of dynamic shared memory a block.
int launch_dual(const DualArgs& a, int E, int cs, cudaStream_t stream) {
  if (a.M < 0 || a.K < 0 || E < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.M * sizeof(float);
  if (smem > kSmemXMax) return (int)cudaErrorInvalidValue;
  return launch_clusters(dual_kernel, (long long)E * cs, cs, smem, stream,
                         a);
}

// Dynamic shared memory of a sweep block with its leftover stripes in it,
// and the float4s a thread holds per chunk (V): 2 for stripes of up to
// 2048 floats, else 8.  Mirrored by budget_alloc.py:sweep_smem.
struct SweepSmem {
  int V;
  size_t left, lists;
};
SweepSmem sweep_smem(int K, int cs, int T) {
  const int ls = 4 * cdiv(cdiv(K, 4), cs);
  const int V = ls <= 4 * 2 * kThreads ? 2 : 8;
  return {V, (size_t)T * ls * sizeof(float),
          (size_t)kWarps * 4 * V * 32 * sizeof(float2)};
}

template <int V, bool kVec, bool kSmem>
int launch_sweep(const SweepArgs& a, long long blocks, int cs, size_t smem,
                 cudaStream_t stream) {
  switch (a.T <= 1 ? 1 : a.T <= 2 ? 2 : a.T <= 4 ? 4 : 8) {
    case 1:
      return launch_clusters(sweep_tile_kernel<V, kVec, kSmem, 1>, blocks,
                             cs, smem, stream, a);
    case 2:
      return launch_clusters(sweep_tile_kernel<V, kVec, kSmem, 2>, blocks,
                             cs, smem, stream, a);
    case 4:
      return launch_clusters(sweep_tile_kernel<V, kVec, kSmem, 4>, blocks,
                             cs, smem, stream, a);
    default:
      return launch_clusters(sweep_tile_kernel<V, kVec, kSmem, 8>, blocks,
                             cs, smem, stream, a);
  }
}

}  // namespace

extern "C" {

// cs, the blocks per row's cluster, is 1, 2, 4 or 8 (the portable cluster
// sizes); the caller picks it (row_split).  A launch the card refuses
// returns its error code; there is no other geometry to fall back to.
int ba_rowmax(const float* g, float* out, int M, int K, int cs,
              cudaStream_t stream) {
  return launch_clusters(rowmax_kernel, (long long)M * cs, cs, 0, stream,
                         g, out, K);
}

// A fleet of E episodes: c [E, M, K], v [E, K] -> y [E, M] (E = 1: one
// matrix); cs is one episode's row_split(M, K), so each episode's y is a
// lone launch's.
int ba_matvec(const float* c, const float* v, float* y, int E, int M, int K,
              int cs, cudaStream_t stream) {
  if (E < 0 || M < 0 || K < 0) return (int)cudaErrorInvalidValue;
  return launch_clusters(matvec_kernel, (long long)E * M * cs, cs, 0, stream,
                         c, v, y, M, K);
}

// c [E, M, K], x [E, M] -> load [E, K].
int ba_matvec_t(const float* c, const float* x, float* load, int E, int M,
                int K, cudaStream_t stream) {
  if (E < 0 || M < 0 || K < 0 || E > 65535) return (int)cudaErrorInvalidValue;
  if (K > 0 && E > 0)
    matvec_t_kernel<<<dim3(cdiv(K, kThreads), E), kThreads, 0, stream>>>(
        c, x, load, M, K);
  return (int)cudaGetLastError();
}

// dual_kernel on one cluster of cs blocks (1, 2, 4 or 8; the caller picks
// it, dual_split).  x needs M * 4 <= ba_dual_smem_limit() bytes of shared
// memory.
int ba_dual_step(const float* c, const float* lam, const float* w_pow,
                 const float* xcap, const int* mask, const float* cap,
                 const float* cap_safe, float* x, float* g, int M, int K,
                 float inv_beta, int cs, cudaStream_t stream) {
  const DualArgs a = {c, lam, w_pow, xcap, mask, cap, cap_safe, x, g,
                      nullptr, nullptr, M, K, inv_beta, 0, 0.0f, 0};
  return launch_dual(a, 1, cs, stream);
}

// The whole SP1 dual ascent from lam0 = lam for each of E episodes: c [E,
// M, K], lam, cap and cap_safe [E, K], w_pow, xcap and mask [E, M] ->
// lam_out [E, K] and iters [E].  tol is float32; adaptive is 0 (step 0.5 /
// (1 + 0.001 it)) or 1 (x1.2 while the KKT error does not rise, else x0.7,
// kept in [0.2, 1.5]).
int ba_dual_ascent(const float* c, const float* lam, const float* w_pow,
                   const float* xcap, const int* mask, const float* cap,
                   const float* cap_safe, float* lam_out, int* iters, int E,
                   int M, int K, float inv_beta, int max_iters, float tol,
                   int adaptive, int cs, cudaStream_t stream) {
  const DualArgs a = {c, lam, w_pow, xcap, mask, cap, cap_safe, nullptr,
                      nullptr, lam_out, iters, M, K, inv_beta, max_iters,
                      tol, adaptive};
  return launch_dual(a, E, cs, stream);
}

size_t ba_dual_smem_limit(void) { return kSmemXMax; }

// How many dual_kernel clusters of cs blocks (x of M rows in shared memory)
// the card runs at once (cudaOccupancyMaxActiveClusters); a fleet of more
// episodes runs its ascents in waves.  Negative: the query's cudaError_t.
int ba_dual_max_clusters(int M, int cs) {
  const size_t smem = (size_t)M * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, dual_kernel, &cfg);
  if (err != 0) {
    cudaGetLastError();
    return -err;
  }
  return n;
}

// kappa_cap is kappa_max - 1, rounded to float32 by the caller.  cs (1,
// 2, 4 or 8) and T (1..8) are the caller's (sweep_split).  The leftover
// stays in shared memory when the T stripes and the warps' lists take at
// most ba_boost_smem_limit() bytes; left_out may be null only then (the
// leftover after the sweep is not written).
int ba_boost_sweep(const float* g_ord, const int* sel, const float* left_in,
                   float* extras, float* left_out, int B, int C, int N, int K,
                   float kappa_cap, int cs, int T, cudaStream_t stream) {
  if (B < 0 || C < 0 || N < 0 || K < 0 || T < 1 || T > kSweepTileMax)
    return (int)cudaErrorInvalidValue;
  if (cs != 1 && cs != 2 && cs != 4 && cs != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const SweepSmem sm = sweep_smem(K, cs, T);
  const bool in_smem = sm.left + sm.lists <= kSweepSmemMax;
  if (!in_smem && left_out == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (in_smem ? sm.left : 0) + sm.lists;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<size_t>(p) & 15) == 0;
  };
  const bool vec = K % 4 == 0 && aligned(g_ord) && aligned(left_in) &&
                   aligned(left_out);
  const int tiles = cdiv(C, T);
  const SweepArgs a = {g_ord, sel, left_in, extras, left_out, C, N, K, T,
                       tiles, 4 * cdiv(cdiv(K, 4), cs), kappa_cap};
  const long long blocks = (long long)B * tiles * cs;
  if (!in_smem)                        // spills only with V = 8
    return vec ? launch_sweep<8, true, false>(a, blocks, cs, smem, stream)
               : launch_sweep<8, false, false>(a, blocks, cs, smem, stream);
  if (sm.V == 2)
    return vec ? launch_sweep<2, true, true>(a, blocks, cs, smem, stream)
               : launch_sweep<2, false, true>(a, blocks, cs, smem, stream);
  return vec ? launch_sweep<8, true, true>(a, blocks, cs, smem, stream)
             : launch_sweep<8, false, true>(a, blocks, cs, smem, stream);
}

size_t ba_boost_smem_limit(void) { return kSweepSmemMax; }

}  // extern "C"
