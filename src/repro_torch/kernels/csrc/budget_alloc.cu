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
// Leftover rows up to this many bytes stay in dynamic shared memory for
// the whole boost sweep; longer rows are updated in the output buffer.
constexpr size_t kSmemLeftMax = 200 * 1024;

struct MaxOp {
  __device__ static float id() { return -INFINITY; }
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};
struct MinOp {
  __device__ static float id() { return INFINITY; }
  __device__ static float op(float a, float b) { return fminf(a, b); }
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

__device__ __forceinline__ RowChunk row_chunk(const float* row, int K,
                                              int rank, int cs) {
  RowChunk c;
  c.h = (int)((16 - (reinterpret_cast<size_t>(row) & 15)) & 15) >> 2;
  if (c.h > K) c.h = K;
  c.nvec = (K - c.h) >> 2;
  c.v0 = (int)((long long)rank * c.nvec / cs);
  c.v1 = (int)((long long)(rank + 1) * c.nvec / cs);
  return c;
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
// one __fmaf_rn per element, in order.  v4 is v at the row's first aligned
// element; kVecV says whether it is 16-byte aligned too (it is for every
// row when K % 4 == 0), else v is read as scalars.  v is shared by all
// rows and comes from L2.
template <bool kVecV>
__device__ __forceinline__ float dot_run(const float4* __restrict__ c4,
                                         const float* __restrict__ v4,
                                         int v0, int v1, float acc) {
  for (int j = v0 + (int)threadIdx.x; j < v1; j += kUnrollDot * kThreads) {
    float4 a[kUnrollDot], b[kUnrollDot];
#pragma unroll
    for (int u = 0; u < kUnrollDot; ++u) {
      const int jj = j + u * kThreads;
      a[u] = b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (jj < v1) {
        a[u] = __ldg(c4 + jj);
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

// y_i = sum_k c_ik v_k.  Grid as rowmax_kernel's.  Per thread an FMA
// chain over its elements (head, its float4s, tail), then warp and block
// tree sums, then the cs partials added in rank order: within 1e-5
// relative of the twin, bitwise from launch to launch (cs depends only on
// M and K).
__global__ void matvec_kernel(const float* __restrict__ c,
                              const float* __restrict__ v,
                              float* __restrict__ y, int K) {
  __shared__ float sh[32];
  __shared__ float parts[kMaxCluster];
  const int cs = (int)cg::this_cluster().num_blocks();
  if (cs > 1) cluster_arrive_relaxed();
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t i = blockIdx.x / cs;
  const float* row = c + i * K;
  const RowChunk ch = row_chunk(row, K, rank, cs);
  const float4* c4 = reinterpret_cast<const float4*>(row + ch.h);
  const float* v4 = v + ch.h;
  const int t = threadIdx.x;
  float acc = 0.0f;
  if (rank == 0 && t < ch.h) acc = __fmaf_rn(row[t], v[t], acc);
  acc = (reinterpret_cast<size_t>(v4) & 15) == 0
            ? dot_run<true>(c4, v4, ch.v0, ch.v1, acc)
            : dot_run<false>(c4, v4, ch.v0, ch.v1, acc);
  const int k_tail = ch.h + 4 * ch.nvec + t;
  if (rank == cs - 1 && k_tail < K)
    acc = __fmaf_rn(row[k_tail], v[k_tail], acc);
  acc = block_reduce<SumOp>(acc, sh);
  cluster_combine<SumOp>(acc, parts, y + i);
}

// load_k = sum_i c_ik x_i: one thread per column k, rows 0..M-1 in order,
// one FMA each.  Neighbouring threads read neighbouring columns of a row,
// so every load is coalesced and no transpose is materialised.
__global__ void matvec_t_kernel(const float* __restrict__ c,
                                const float* __restrict__ x,
                                float* __restrict__ load, int M, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
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
  int M, K;
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

__global__ void __launch_bounds__(kThreads)
dual_kernel(DualArgs a) {
  extern __shared__ float xs[];                  // x, all M rows
  __shared__ float sh[kDualRows][32];
  __shared__ float parts[kMaxCluster];           // the blocks' KKT parts
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
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
// One block per (batch b, candidate c).  The candidate's leftover row lives
// in dynamic shared memory (or, when K*4 bytes exceed kSmemLeftMax, in its
// row of left_out) for the whole N-step sweep; each thread owns the same
// strided columns at every step, so the leftover needs no barrier of its
// own.  A selected visit j takes a block-wide min of left_k / max(g_jk,
// 1e-9) over live k (g_jk > 1e-9), clips it to [0, kappa_max - 1] and
// debits left_k = fma(-extra, g_jk, left_k).  An unselected visit is
// skipped: bitwise the same as the reference's debit of 0 * g_j.
__global__ void boost_sweep_kernel(const float* __restrict__ g_ord,
                                   const int* __restrict__ sel,
                                   const float* __restrict__ left_in,
                                   float* __restrict__ extras,
                                   float* __restrict__ left_out,
                                   int C, int N, int K, float kappa_cap,
                                   int left_in_smem) {
  extern __shared__ float smem_left[];
  __shared__ float sh[32];
  const size_t bc = blockIdx.x;
  const float* g = g_ord + (bc / C) * (size_t)N * K;
  const int* s = sel + bc * N;
  const float* lin = left_in + bc * K;
  float* left = left_in_smem ? smem_left : left_out + bc * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) left[k] = lin[k];
  for (int j = 0; j < N; ++j) {
    if (s[j] == 0) {                     // same branch for the whole block
      if (threadIdx.x == 0) extras[bc * N + j] = 0.0f;
      continue;
    }
    const float* gj = g + (size_t)j * K;
    float m = INFINITY;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float d = gj[k];
      const float r = d > kBoostEps ? left[k] / fmaxf(d, kBoostEps) : INFINITY;
      m = fminf(m, r);
    }
    m = block_reduce<MinOp>(m, sh);
    const float e = fminf(fmaxf(m, 0.0f), kappa_cap);
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      left[k] = __fmaf_rn(-e, gj[k], left[k]);
    if (threadIdx.x == 0) extras[bc * N + j] = e;
  }
  if (left_in_smem && left_out != nullptr)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      left_out[bc * K + k] = left[k];
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Launch `kernel(args...)` on a 1-D grid of cs * M blocks in clusters of
// cs (cudaLaunchAttributeClusterDimension), so the cs blocks of row i are
// one cluster; M is not held to gridDim.y's 65,535.
template <typename... Params, typename... Args>
int launch_row_clusters(void (*kernel)(Params...), int M, int cs,
                        cudaStream_t stream, Args... args) {
  if (cs != 1 && cs != 2 && cs != 4 && cs != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  if ((long long)M * cs > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(M * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();                  // clear it for the next launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// One cluster of cs blocks running dual_kernel, x in M * 4 bytes of
// dynamic shared memory.
int launch_dual(const DualArgs& a, int cs, cudaStream_t stream) {
  if (cs != 1 && cs != 2 && cs != 4 && cs != kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (a.M < 0 || a.K < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.M * sizeof(float);
  if (smem > kSmemXMax) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemXMax);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, dual_kernel, a);
  if (e != cudaSuccess) {
    cudaGetLastError();                  // clear it for the next launch
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cs, the blocks per row's cluster, is 1, 2, 4 or 8 (the portable cluster
// sizes); the caller picks it (row_split).  A launch the card refuses
// returns its error code; there is no other geometry to fall back to.
int ba_rowmax(const float* g, float* out, int M, int K, int cs,
              cudaStream_t stream) {
  return launch_row_clusters(rowmax_kernel, M, cs, stream, g, out, K);
}

int ba_matvec(const float* c, const float* v, float* y, int M, int K, int cs,
              cudaStream_t stream) {
  return launch_row_clusters(matvec_kernel, M, cs, stream, c, v, y, K);
}

int ba_matvec_t(const float* c, const float* x, float* load, int M, int K,
                cudaStream_t stream) {
  if (K > 0)
    matvec_t_kernel<<<cdiv(K, kThreads), kThreads, 0, stream>>>(c, x, load,
                                                                M, K);
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
  return launch_dual(a, cs, stream);
}

// The whole SP1 dual ascent from lam0 = lam: lam_out [K] and *iters.  tol
// is float32; adaptive is 0 (step 0.5 / (1 + 0.001 it)) or 1 (x1.2 while
// the KKT error does not rise, else x0.7, kept in [0.2, 1.5]).
int ba_dual_ascent(const float* c, const float* lam, const float* w_pow,
                   const float* xcap, const int* mask, const float* cap,
                   const float* cap_safe, float* lam_out, int* iters, int M,
                   int K, float inv_beta, int max_iters, float tol,
                   int adaptive, int cs, cudaStream_t stream) {
  const DualArgs a = {c, lam, w_pow, xcap, mask, cap, cap_safe, nullptr,
                      nullptr, lam_out, iters, M, K, inv_beta, max_iters,
                      tol, adaptive};
  return launch_dual(a, cs, stream);
}

size_t ba_dual_smem_limit(void) { return kSmemXMax; }

// kappa_cap is kappa_max - 1, rounded to float32 by the caller.  left_out
// may be null only when K * 4 <= ba_boost_smem_limit() (the leftover then
// stays in shared memory and is not written back).
int ba_boost_sweep(const float* g_ord, const int* sel, const float* left_in,
                   float* extras, float* left_out, int B, int C, int N, int K,
                   float kappa_cap, cudaStream_t stream) {
  const size_t row_bytes = (size_t)K * sizeof(float);
  const int in_smem = row_bytes <= kSmemLeftMax;
  if (!in_smem && left_out == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? row_bytes : 0;
  int err = (int)cudaFuncSetAttribute(
      boost_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemLeftMax);
  if (err != 0) return err;
  const long long blocks = (long long)B * C;
  if (blocks > 0)
    boost_sweep_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        g_ord, sel, left_in, extras, left_out, C, N, K, kappa_cap,
        in_smem);
  return (int)cudaGetLastError();
}

size_t ba_boost_smem_limit(void) { return kSmemLeftMax; }

}  // extern "C"
