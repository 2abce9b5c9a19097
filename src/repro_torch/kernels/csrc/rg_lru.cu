// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a).
//
// Hand-written replacement of the Pallas TPU kernel
// src/repro/kernels/rg_lru.py:43 rglru_scan:
//
//   rg_scan   a, b [B,S,D], h0 [B,D] (or null: zeros) -> h [B,S,D]
//             h_t = a_t * h_{t-1} + b_t for t = 0..S-1, every h_t stored
//
// It runs where repro calls models/recurrent.py:linear_scan: the prefill
// of every `rec` block (S steps from h0 = 0) and every decode step (S = 1
// from the cached h).  Each step is one __fmaf_rn(a, h, b): the site where
// XLA contracts `a * h + b` into a fused multiply-add, so the kernel is
// bitwise equal to repro_torch/kernels/ref.py:rglru_scan_ref (and to
// repro's lax.scan oracle and Pallas kernel) at every shape.  No fast math.
//
// Plain C interface (loaded with ctypes by repro_torch/kernels/build.py):
// device pointers, sizes and PyTorch's current stream; launches on that
// stream, does not synchronise or allocate, returns cudaGetLastError().
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes.  a and b are read once and
// h written once, 12*B*S*D bytes: 251.7 MB, 0.0751 ms at B=4, S=2048,
// D=2560.  One FMA per 12 bytes is far below the card's float32 rate.
//
// Design.  The recurrence is independent per (b, d) channel and sequential
// in t, so one thread owns one channel and walks t; a warp's 32 consecutive
// channels read one 128-byte line of a and of b per step and write one of
// h.  The loads do not depend on h, so the loop is software-pipelined:
// the next kAhead steps of a and b are loaded while the current kAhead are
// folded into h.  Blocks of 64 threads over D and one grid row per batch
// row spread B*D/64 blocks over the 132 SMs.  Any S and D (Pallas asserts
// divisibility by its blocks; here the last block masks the ragged D).
// At B*D = 10,240 channels the card holds few loads in flight per SM, so
// a long prefill runs well above its bound; a chunked two-pass scan would
// fill the card but rounds differently from the sequential twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kAhead = 16;     // steps of a and b loaded ahead

__global__ void __launch_bounds__(kThreads)
rg_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ h0, float* __restrict__ h_out,
               int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t base = row * (size_t)S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = h_out + base;
  float h = h0 != nullptr ? h0[row * D + d] : 0.0f;

  float av[kAhead], bv[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool in = u < S;
    av[u] = in ? __ldg(ap + (size_t)u * D) : 0.0f;
    bv[u] = in ? __ldg(bp + (size_t)u * D) : 0.0f;
  }
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    // the next kAhead steps' operands, in flight while h advances
    float an[kAhead], bn[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      const bool in = t < S;
      an[u] = in ? __ldg(ap + (size_t)t * D) : 0.0f;
      bn[u] = in ? __ldg(bp + (size_t)t * D) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t < S) {
        h = __fmaf_rn(av[u], h, bv[u]);
        op[(size_t)t * D] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
  }
}

}  // namespace

extern "C" {

// h[b, t, :] = a[b, t, :] * h[b, t-1, :] + b[b, t, :], h[b, -1, :] = h0[b]
// (zeros when h0 is null).
int rg_scan(const float* a, const float* b, const float* h0, float* h, int B,
            int S, int D, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  rg_scan_kernel<<<grid, kThreads, 0, stream>>>(a, b, h0, h, S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
