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
// Launch 1: one block per row i forms the denominator sum_k c_ik lam_k,
// then x_i = min((w_pow_i / max(denom, 1e-12))^(1/beta), xcap_i), masked.
__global__ void dual_x_kernel(const float* __restrict__ c,
                              const float* __restrict__ lam,
                              const float* __restrict__ w_pow,
                              const float* __restrict__ xcap,
                              const int* __restrict__ mask,
                              float* __restrict__ x, int K, float inv_beta) {
  __shared__ float sh[32];
  const int i = blockIdx.x;
  const float* row = c + (size_t)i * K;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    acc = __fmaf_rn(row[k], lam[k], acc);
  acc = block_reduce<SumOp>(acc, sh);
  if (threadIdx.x == 0) {
    const float denom = fmaxf(acc, kDualEps);
    float xi = powf(w_pow[i] / denom, inv_beta);
    xi = fminf(xi, xcap[i]);
    x[i] = mask[i] != 0 ? xi : 0.0f;
  }
}

// Launch 2: one thread per column k sums the load over rows 0..M-1 in
// order (the TPU kernel's sequential grid carry, turned into a loop inside
// the thread), then g_k = (load_k - cap_k) / cap_safe_k.
__global__ void dual_g_kernel(const float* __restrict__ c,
                              const float* __restrict__ x,
                              const float* __restrict__ cap,
                              const float* __restrict__ cap_safe,
                              float* __restrict__ g, int M, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float load = 0.0f;
  for (int i = 0; i < M; ++i)
    load = __fmaf_rn(c[(size_t)i * K + k], x[i], load);
  g[k] = (load - cap[k]) / cap_safe[k];
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

int ba_dual_step(const float* c, const float* lam, const float* w_pow,
                 const float* xcap, const int* mask, const float* cap,
                 const float* cap_safe, float* x, float* g, int M, int K,
                 float inv_beta, cudaStream_t stream) {
  if (M > 0)
    dual_x_kernel<<<M, kThreads, 0, stream>>>(c, lam, w_pow, xcap, mask, x,
                                              K, inv_beta);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (K > 0)
    dual_g_kernel<<<cdiv(K, kThreads), kThreads, 0, stream>>>(
        c, x, cap, cap_safe, g, M, K);
  return (int)cudaGetLastError();
}

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
