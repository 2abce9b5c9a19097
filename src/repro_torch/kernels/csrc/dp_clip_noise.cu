// DP clip-and-accumulate kernels for NVIDIA Hopper (sm_90a).
//
// Hand-written replacements of the Pallas TPU kernels in
// src/repro/kernels/dp_clip_noise.py, the contract of DP-FedAvg's
// aggregation (repro/training/fedavg.py::aggregate) and of DP-SGD's
// per-example clip (repro/training/dp_sgd.py, example mode):
//
//   dp_rownorms(g [B,P])                -> [B]  sum_p g_bp^2   (rownorms, :41)
//   dp_clip_accumulate(g [B,P], s [B])  -> [P]  sum_b s_b g_bp (clip_accumulate, :73)
//
// Plain C interface (loaded with ctypes by repro_torch/kernels/build.py):
// every entry point takes device pointers, the sizes and PyTorch's current
// stream, launches on that stream, does not synchronise or allocate, and
// returns cudaGetLastError().
//
// Bound: both are streaming passes over B*P float32 values, bytes-bound
// on HBM (at B=6, P=124,668,672: 2.99 GB read, 0.89 ms at 3.35 TB/s for
// rownorms; 2.99 GB read + 0.50 GB written, 1.04 ms for clip_accumulate).
//
// Design.  The TPU kernels carry each partial sum along a sequential grid
// axis; Hopper's blocks run in no order and carry nothing, and one block
// per example row would fill B of 132 SMs.
//   * rownorms: a grid of (chunk, row) blocks, each summing the squares of
//     kChunk consecutive elements of one row (FMA per element, fixed
//     warp-shuffle tree), written to a partial buffer; a second launch,
//     one block per row, adds the row's partials in float64 in a fixed
//     order and rounds once.  No atomics: the result is bitwise the same
//     from run to run (the clip is privacy-critical and must be
//     auditable); it agrees with torch.sum(g * g, -1) to float32 rounding.
//   * clip_accumulate: one thread per column, or per 4 columns where the
//     loads are 16-byte vectors; rows b = 0..B-1 in order,
//     each one __fmaf_rn(g_bp, s_b, acc) -- the Pallas body `acc += g * s`
//     as XLA contracts it -- so the result is bitwise the twin's.
//   Both read 16-byte vectors when P % 4 == 0 and the rows are 16-byte
//   aligned, and fall back to scalar loads otherwise; the ragged tail is
//   masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kVec = 4;                       // floats per 16-byte load
constexpr int kChunk = kThreads * kVec * 16;  // row elements per partial

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum in a fixed order; thread 0 gets the result.  `sh` holds
// 32 values.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : T(0);
  if (wid == 0) v = warp_sum(v);
  return v;
}

// 16-byte vector loads need every row to start on a 16-byte boundary.
bool vectorizable(const void* a, const void* b, long long P) {
  return (P % kVec) == 0 && (reinterpret_cast<uintptr_t>(a) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
}

// ------------------------------------------------------------- rownorms
// Launch 1: block (c, b) sums g_bp^2 over p in [c*kChunk, (c+1)*kChunk).
template <bool kVec4>
__global__ void rownorm_partial_kernel(const float* __restrict__ g,
                                       float* __restrict__ partial,
                                       long long P, int n_chunks) {
  __shared__ float sh[32];
  const int c = blockIdx.x, b = blockIdx.y;
  const float* row = g + (size_t)b * (size_t)P;
  const long long start = (long long)c * kChunk;
  const long long end = start + kChunk < P ? start + kChunk : P;
  float acc = 0.0f;
  if (kVec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (long long i = start / kVec + threadIdx.x; i < end / kVec;
         i += blockDim.x) {
      const float4 v = __ldg(row4 + i);
      acc = __fmaf_rn(v.x, v.x, acc);
      acc = __fmaf_rn(v.y, v.y, acc);
      acc = __fmaf_rn(v.z, v.z, acc);
      acc = __fmaf_rn(v.w, v.w, acc);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
      const float v = __ldg(row + i);
      acc = __fmaf_rn(v, v, acc);
    }
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[(size_t)b * n_chunks + c] = acc;
}

// Launch 2: block b adds its row's partials in float64, rounds once.
__global__ void rownorm_finish_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int n_chunks) {
  __shared__ double sh[32];
  const int b = blockIdx.x;
  const float* row = partial + (size_t)b * n_chunks;
  double acc = 0.0;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) acc += row[c];
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) out[b] = (float)acc;
}

// ------------------------------------------------------- clip_accumulate
// One thread per column (kVec4: per 4 columns), rows in order, one FMA
// each.  Neighbouring threads read neighbouring columns: coalesced.
template <bool kVec4>
__global__ void clip_accumulate_kernel(const float* __restrict__ g,
                                       const float* __restrict__ s,
                                       float* __restrict__ out, int B,
                                       long long P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec4) {
    const long long P4 = P / kVec;
    if (t >= P4) return;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const float4 v = __ldg(g4 + (size_t)b * (size_t)P4 + t);
      const float sb = __ldg(s + b);
      acc.x = __fmaf_rn(v.x, sb, acc.x);
      acc.y = __fmaf_rn(v.y, sb, acc.y);
      acc.z = __fmaf_rn(v.z, sb, acc.z);
      acc.w = __fmaf_rn(v.w, sb, acc.w);
    }
    reinterpret_cast<float4*>(out)[t] = acc;
  } else {
    if (t >= P) return;
    float acc = 0.0f;
#pragma unroll 4
    for (int b = 0; b < B; ++b)
      acc = __fmaf_rn(__ldg(g + (size_t)b * (size_t)P + t), __ldg(s + b),
                      acc);
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

// Elements of one row summed into each partial of dp_rownorms; the
// caller's `partial` scratch holds B * ceil(P / chunk) floats.
int dp_rownorms_chunk(void) { return kChunk; }

int dp_rownorms(const float* g, float* out, float* partial, int B,
                long long P, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;      // grid.y limit
  const long long n_chunks = (P + kChunk - 1) / kChunk;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const dim3 grid((unsigned)n_chunks, (unsigned)B);
    if (vectorizable(g, g, P))
      rownorm_partial_kernel<true><<<grid, kThreads, 0, stream>>>(
          g, partial, P, (int)n_chunks);
    else
      rownorm_partial_kernel<false><<<grid, kThreads, 0, stream>>>(
          g, partial, P, (int)n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rownorm_finish_kernel<<<B, kThreads, 0, stream>>>(partial, out,
                                                     (int)n_chunks);
  return (int)cudaGetLastError();
}

int dp_clip_accumulate(const float* g, const float* scales, float* out,
                       int B, long long P, cudaStream_t stream) {
  const bool vec = vectorizable(g, out, P);
  const long long threads = vec ? P / kVec : P;
  if (threads == 0) return (int)cudaGetLastError();
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    clip_accumulate_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, scales, out, B, P);
  else
    clip_accumulate_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, scales, out, B, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
