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
// tree sum over K and agree to float32 rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
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

// ---------------------------------------------------------------- rowmax
// mu_i = max_k g_ik: one block per row, strided loop over K, warp-shuffle
// then shared-memory max.  Max is order-free, so bitwise equal to amax.
__global__ void rowmax_kernel(const float* __restrict__ g,
                              float* __restrict__ out, int K) {
  __shared__ float sh[32];
  const float* row = g + (size_t)blockIdx.x * K;
  float m = kNegInit;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, row[k]);
  m = block_reduce<MaxOp>(m, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = m;
}

// ---------------------------------------------------------------- matvec
// y_i = sum_k c_ik v_k: one block per row, fp32 FMA per thread, tree sum.
__global__ void matvec_kernel(const float* __restrict__ c,
                              const float* __restrict__ v,
                              float* __restrict__ y, int K) {
  __shared__ float sh[32];
  const float* row = c + (size_t)blockIdx.x * K;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    acc = __fmaf_rn(row[k], v[k], acc);
  acc = block_reduce<SumOp>(acc, sh);
  if (threadIdx.x == 0) y[blockIdx.x] = acc;
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

}  // namespace

extern "C" {

int ba_rowmax(const float* g, float* out, int M, int K, cudaStream_t stream) {
  if (M > 0) rowmax_kernel<<<M, kThreads, 0, stream>>>(g, out, K);
  return (int)cudaGetLastError();
}

int ba_matvec(const float* c, const float* v, float* y, int M, int K,
              cudaStream_t stream) {
  if (M > 0) matvec_kernel<<<M, kThreads, 0, stream>>>(c, v, y, K);
  return (int)cudaGetLastError();
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
