// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a).
//
// Hand-written replacement of the Pallas TPU kernel
// src/repro/kernels/rg_lru.py:43 rglru_scan:
//
//   rg_scan   a, b [B,S,D], h0 [B,D] (or null: zeros) -> h [B,S,D]
//             h_t = a_t * h_{t-1} + b_t for t = 0..S-1, every h_t stored
//
//   rg_scan_bwd  a, dL/dh, h [B,S,D], h0 [B,D] (or null)
//             -> dL/da, dL/db [B,S,D], dL/dh0 [B,D] (when h0 is given)
//             the scan's gradient, run backward in t (below)
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
// in t.  The bitwise contract fixes the order: one correctly rounded FMA
// per step, t = 0, 1, ...  A chunked two-pass scan (more threads on a
// channel) would round differently, so it is not taken, and the only
// parallelism is the B*D channels: one thread owns one channel, a warp 32
// consecutive channels, and a step of a warp reads one 128-byte row of a
// and of b and writes one of h.  The FMA chain does almost no work, so
// the time is how many bytes are in flight: the card needs about its rate
// times an HBM load's latency, 3.35 TB/s x 0.6-0.8 us = 2-2.7 MB.  A
// register prefetch of 16 steps held 10,240 x 16 x 8 B = 1.3 MB at
// recurrentgemma-2b's B*D and ran at half the bound.
//
// So each warp streams its channels' future a and b through a ring of
// kStages slots of `stage` steps in shared memory, filled asynchronously
// ahead of the chain: kStages - 1 stages are in flight while one is folded
// into h.  Lane 0 loads a stage's a and b as boxes (32 channels x stage
// steps of one row) with tensor maps, completing on the slot's mbarrier;
// the warp writes h into one of two h slots and lane 0 stores it as a box.
// Boxes past S or D are zero-filled on load and clipped on store.  The
// launcher sizes `stage` from B*D (rg_lru.py:scan_geometry): (kStages - 1)
// x stage x 8 B x B*D >= 3.5 MB, rounded up to kStep steps, capped by
// kStageMax and so that the ring never exceeds S.  That is 16 steps a
// stage (3.9 MB in flight) at B*D = 10,240 and the cap, 48, at 2,560.  On
// an H100 more in flight lost at B*D = 10,240 (7.9 MB: 9% slower), and at
// 2,560 the time is a fixed cost a stage (about 0.3 us) plus the steps,
// so the largest stage wins (PERF.md).  4- and 16-byte cp.async and one
// bulk copy a row were measured and lost to the tensor maps; one-warp
// blocks tied with two-warp blocks (kChannels) on the card.
//
// Tensor maps need D % 4 == 0 and 16-byte aligned a, b and h.  Any other
// shape, and S < kStages * kStep (the decode step among them), gets stage
// 0 from the launcher: the direct path, no ring, the next kAhead steps
// loaded into registers (one load round, one FMA and one store at S = 1).
// The last block masks a ragged D; any S.
//
// The gradient (rg_scan_bwd_at) has the same two paths.  Its chain runs
// from t = S - 1 down and moves 20 bytes a step and channel (a, dL/dh and
// h_{t-1} read, dL/da and dL/db written).  The parent's register prefetch
// of kAhead steps kept 0.5-2 MB in flight and ran at 0.20 of the bound at
// B = 1.  rg_scan_bwd_ring_kernel streams a, dL/dh and h through three
// rings of kStages slots a warp, stages on multiples of `stage` walked
// from the last (the h box one step earlier, so that its row r holds
// h_{t-1} of the a row r), and stores dL/da and dL/db as boxes from two
// slots each: (3 kStages + 4) x stage x 128 bytes a warp, 98,304 at the
// largest stage.  Where the stage does not divide S the first stage runs
// past S: those rows load as zeros, which keep the carry +0, and are
// clipped on store; the h row of step 0 is overwritten with h0 (or 0).
// The launcher takes the largest stage that keeps at most 4.5 MB of the
// three operands in flight (rg_lru.py:scan_bwd_geometry): 8 steps at B*D
// = 10,240, 24 at 5,120, 48 at 2,560.  On an H100 a larger stage was
// faster up to ~4.4 MB in flight and 3-16% slower past it; one-warp
// blocks (kBwdChannels) put B = 1 x D = 2,560 on 80 SMs and beat two-warp
// blocks there (PERF.md).  Stage 0 (S < 32, D % 4 != 0, operands off
// 16-byte alignment) runs rg_scan_bwd_kernel, the direct path.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;       // ring slots
constexpr int kStep = 8;         // a stage is a multiple of kStep steps
constexpr int kStageMax = 48;    // steps a stage
constexpr int kChannels = 64;    // channels (threads) a block
constexpr int kBwdChannels = 32; // the gradient's ring: channels a block
constexpr int kAhead = 16;       // direct path: steps loaded ahead

// A warp's shared memory, in floats: the a and b rings (kStages slots of
// stage x 32 each) and two h slots, a multiple of 128 bytes; a block's is
// its warps', then each warp's kStages mbarriers.
__host__ __device__ constexpr size_t warp_floats(int stage) {
  return (size_t)(2 * kStages + 2) * stage * 32;
}
__host__ __device__ constexpr size_t smem_bytes(int stage) {
  return (size_t)(kChannels / 32) *
         (warp_floats(stage) * sizeof(float) + kStages * sizeof(uint64_t));
}
// The gradient's ring, per warp: the a, dL/dh and h rings and two slots
// each of dL/da and dL/db; per block, its warps' and their mbarriers.
__host__ __device__ constexpr size_t bwd_warp_floats(int stage) {
  return (size_t)(3 * kStages + 4) * stage * 32;
}
__host__ __device__ constexpr size_t bwd_smem_bytes(int stage) {
  return (size_t)(kBwdChannels / 32) *
         (bwd_warp_floats(stage) * sizeof(float) + kStages * sizeof(uint64_t));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
      ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// box (32 channels x stage steps x 1 row) at (channel c, step t, row r)
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int c, int t, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(r),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              const float* src, int c, int t,
                                              int r) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3}], [%4];" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t),
      "r"(r), "r"(smem_u32(src)) : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// one box, its own bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int c, int t,
                                          int r) {
  tma_store_box(map, src, c, t, r);
  tma_store_commit();
}
template <int kPending>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

// Direct path (stage 0): the next kAhead steps of a and b in registers
// while the current kAhead are folded into h.
__global__ void __launch_bounds__(kChannels)
rg_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ h0, float* __restrict__ h_out,
               int S, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
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

// Ring path: each warp owns 32 channels and a ring of kStages slots
// (warp_floats), stage st in slot st % kStages, the next kStages - 1
// stages in flight while one is folded into h.  Lane 0 loads a stage's a
// and b as boxes (32 channels x stage steps of one row) with the tensor
// maps ta and tb, counted on the slot's mbarrier; the warp writes h into
// one of two h slots and lane 0 stores it as a box with th.
__global__ void __launch_bounds__(kChannels)
rg_scan_ring_kernel(const float* __restrict__ h0, int S, int D, int stage,
                    const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap th) {
  extern __shared__ __align__(128) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kChannels + warp * 32;   // warp's 1st channel
  if (w0 >= D) return;                                 // the whole warp
  const int d = w0 + lane;
  const int row = blockIdx.y;
  const int slot = stage * 32;                         // floats a slot
  float* ra = smem + warp * warp_floats(stage);
  float* rb = ra + kStages * slot;
  float* rh = rb + kStages * slot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + (kChannels / 32) * warp_floats(stage)) +
                   warp * kStages;
  const int nst = (S + stage - 1) / stage;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Start stage st's loads into slot st % kStages (nothing past S).
  auto issue = [&](int st) {
    if (lane == 0 && st < nst) {
      uint64_t* bar = bars + st % kStages;
      mbar_expect(bar, 2u * (unsigned)slot * 4u);
      tma_load(ra + (st % kStages) * slot, &ta, w0, st * stage, row, bar);
      tma_load(rb + (st % kStages) * slot, &tb, w0, st * stage, row, bar);
    }
  };

  for (int st = 0; st < kStages - 1; ++st) issue(st);
  float h = d < D && h0 != nullptr ? h0[(size_t)row * D + d] : 0.0f;
  for (int st = 0; st < nst; ++st) {
    __syncwarp();   // every lane is done with the slot this refills
    issue(st + kStages - 1);
    const float* sa = ra + (st % kStages) * slot + lane;
    const float* sb = rb + (st % kStages) * slot + lane;
    mbar_wait(bars + st % kStages, (unsigned)(st / kStages) & 1u);
    if (lane == 0) tma_store_wait_read<1>();    // h slot's store of st - 2
    __syncwarp();
    float* hs = rh + (st & 1) * slot;
    for (int u = 0; u < stage; u += kStep) {     // rows past S are zeros
      float av[kStep], bv[kStep];
#pragma unroll
      for (int v = 0; v < kStep; ++v) {
        av[v] = sa[(u + v) * 32];
        bv[v] = sb[(u + v) * 32];
      }
#pragma unroll
      for (int v = 0; v < kStep; ++v) {
        h = __fmaf_rn(av[v], h, bv[v]);
        hs[(u + v) * 32 + lane] = h;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) tma_store(&th, hs, w0, st * stage, row);
  }
  if (lane == 0) tma_store_wait_read<0>();
}

// The scan's gradient (rg_scan_bwd).  No Pallas kernel replaced: repro
// takes the gradient of models/recurrent.py:64 linear_scan by autodiff of
// jax.lax.associative_scan.  The contract is the twin's,
// repro_torch/kernels/rg_lru.py:_TwinScan.backward: from t = S - 1 down
// to 0, carry = dL/dh_t + carry (rounded), dL/db_t = carry, dL/da_t =
// carry * h_{t-1} (rounded; h0, or zero, at t = 0), carry = a_t * carry
// (rounded); dL/dh0 is the last carry.  The twin rounds each product and
// each sum, so they are __fmul_rn / __fadd_rn here: nvcc would otherwise
// contract `dL/dh_t + a_{t+1} * carry` into one FMA, and the result would
// not be bitwise the twin's.
//
// Bound: bytes.  a, dL/dh and h are read once, dL/da and dL/db written
// once: 20*B*S*D bytes, 0.1252 ms at B=4, S=2048, D=2560 on an H100 SXM.
// Two kernels, as in the forward: rg_scan_bwd_ring_kernel (below) where
// the launcher gives a stage, and this one, the direct path, at stage 0:
// the forward's direct path run backward -- one thread a (b, d) channel,
// a warp 32 consecutive channels (coalesced rows), the next kAhead steps
// of a, dL/dh and h_{t-1} loaded into registers while the current kAhead
// are folded.  Any B (up to 65,535), S and D; a ragged D masked in the
// last block.
__global__ void __launch_bounds__(kChannels)
rg_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ gh,
                   const float* __restrict__ h, const float* __restrict__ h0,
                   float* __restrict__ da, float* __restrict__ db,
                   float* __restrict__ dh0, int S, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t base = row * (size_t)S * D + d;
  const float* ap = a + base;
  const float* gp = gh + base;
  const float* hp = h + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float first = h0 != nullptr ? h0[row * D + d] : 0.0f;

  // step t's a, dL/dh and h_{t-1}; zeros before t = 0
  auto load = [&](int t, float& av, float& gv, float& pv) {
    const bool in = t >= 0;
    av = in ? __ldg(ap + (size_t)t * D) : 0.0f;
    gv = in ? __ldg(gp + (size_t)t * D) : 0.0f;
    pv = t > 0 ? __ldg(hp + (size_t)(t - 1) * D) : first;
  };
  float av[kAhead], gv[kAhead], pv[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) load(S - 1 - u, av[u], gv[u], pv[u]);
  float carry = 0.0f;
  for (int t0 = S - 1; t0 >= 0; t0 -= kAhead) {
    float an[kAhead], gn[kAhead], pn[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) load(t0 - kAhead - u, an[u], gn[u], pn[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        carry = __fadd_rn(gv[u], carry);
        dbp[(size_t)t * D] = carry;
        dap[(size_t)t * D] = __fmul_rn(carry, pv[u]);
        carry = __fmul_rn(av[u], carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = an[u];
      gv[u] = gn[u];
      pv[u] = pn[u];
    }
  }
  if (dh0 != nullptr) dh0[row * D + d] = carry;
}

// The gradient's ring path: rg_scan_ring_kernel's design run from the
// end of S down.  Each warp owns 32 channels, three input rings (a, dL/dh
// and h) of kStages slots of `stage` steps, and two slots each of dL/da
// and dL/db (bwd_warp_floats).  Stages sit on multiples of `stage` from
// step 0: stage st covers steps [t_lo, t_lo + stage) with t_lo = (nst - 1
// - st) * stage, in slot st % kStages; the next kStages - 1 stages are in
// flight while one is folded.  Lane 0 loads a stage's a and dL/dh boxes
// at step t_lo and its h box at t_lo - 1, so that row r of the h slot
// holds h_{t-1} of step t = t_lo + r; all three count on the slot's
// mbarrier.  Where the stage does not divide S, the first stage runs past
// S: the tensor maps zero-fill those rows (and rows past D) and clip them
// on store, and folding zeros keeps the carry +0, as it starts.  The h
// row of step 0 (at step -1, zero-filled) is overwritten with h0 (or 0)
// before the last stage's fold; no later stage refills that slot.
// (Stages cut from S down instead, the last starting before step 0, put
// the a, dL/dh, dL/da and dL/db boxes at negative steps; on an H100 that
// faulted with an illegal instruction.)  The warp writes dL/da and dL/db
// into the slot pair st & 1 and lane 0 stores both as boxes in one bulk
// group.
__global__ void __launch_bounds__(kBwdChannels)
rg_scan_bwd_ring_kernel(const float* __restrict__ h0,
                        float* __restrict__ dh0, int S, int D, int stage,
                        const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tda,
                        const __grid_constant__ CUtensorMap tdb) {
  extern __shared__ __align__(128) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kBwdChannels + warp * 32;  // warp's 1st channel
  if (w0 >= D) return;                                   // the whole warp
  const int d = w0 + lane;
  const int row = blockIdx.y;
  const int slot = stage * 32;                           // floats a slot
  float* ra = smem + warp * bwd_warp_floats(stage);
  float* rg = ra + kStages * slot;
  float* rh = rg + kStages * slot;
  float* rda = rh + kStages * slot;
  float* rdb = rda + 2 * slot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + (kBwdChannels / 32) * bwd_warp_floats(stage)) +
                   warp * kStages;
  const int nst = (S + stage - 1) / stage;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Start stage st's loads into slot st % kStages.
  auto issue = [&](int st) {
    if (lane == 0 && st < nst) {
      const int s = st % kStages;
      const int t_lo = (nst - 1 - st) * stage;
      mbar_expect(bars + s, 3u * (unsigned)slot * 4u);
      tma_load(ra + s * slot, &ta, w0, t_lo, row, bars + s);
      tma_load(rg + s * slot, &tg, w0, t_lo, row, bars + s);
      tma_load(rh + s * slot, &th, w0, t_lo - 1, row, bars + s);
    }
  };

  for (int st = 0; st < kStages - 1; ++st) issue(st);
  const float first = d < D && h0 != nullptr ? h0[(size_t)row * D + d] : 0.0f;
  float carry = 0.0f;
  for (int st = 0; st < nst; ++st) {
    __syncwarp();   // every lane is done with the slot this refills
    issue(st + kStages - 1);
    const int s = st % kStages;
    const int t_lo = (nst - 1 - st) * stage;
    const float* sa = ra + s * slot + lane;
    const float* sg = rg + s * slot + lane;
    float* sh = rh + s * slot + lane;
    mbar_wait(bars + s, (unsigned)(st / kStages) & 1u);
    if (lane == 0) tma_store_wait_read<1>();     // slot pair's stores of st - 2
    __syncwarp();
    if (t_lo == 0) sh[0] = first;                // h_{-1} of step 0
    float* oa = rda + (st & 1) * slot + lane;
    float* ob = rdb + (st & 1) * slot + lane;
    for (int u = stage - kStep; u >= 0; u -= kStep) {
      float av[kStep], gv[kStep], pv[kStep];
#pragma unroll
      for (int v = 0; v < kStep; ++v) {
        av[v] = sa[(u + v) * 32];
        gv[v] = sg[(u + v) * 32];
        pv[v] = sh[(u + v) * 32];
      }
#pragma unroll
      for (int v = kStep - 1; v >= 0; --v) {
        carry = __fadd_rn(gv[v], carry);
        ob[(u + v) * 32] = carry;
        oa[(u + v) * 32] = __fmul_rn(carry, pv[v]);
        carry = __fmul_rn(av[v], carry);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      tma_store_box(&tda, oa - lane, w0, t_lo, row);
      tma_store_box(&tdb, ob - lane, w0, t_lo, row);
      tma_store_commit();
    }
  }
  if (lane == 0) tma_store_wait_read<0>();
  if (dh0 != nullptr && d < D) dh0[(size_t)row * D + d] = carry;
}

// cuTensorMapEncodeTiled from libcuda, found through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [B, S, D] float32 at x, in boxes of 32 channels x stage steps x 1 row.
bool box_map(CUtensorMap* map, const float* x, int B, int S, int D,
             int stage) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)stage, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the tensor maps take [B, S, D] operands at these addresses.
template <typename... P>
bool wide(int D, const P*... x) {
  return D % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) % 16 == 0) && ...);
}

cudaError_t launch_ring(const float* a, const float* b, const float* h0,
                        float* h, int B, int S, int D, int stage,
                        cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rg_scan_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kStageMax));
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[3];
  if (!(box_map(&maps[0], a, B, S, D, stage) &&
        box_map(&maps[1], b, B, S, D, stage) &&
        box_map(&maps[2], h, B, S, D, stage)))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  rg_scan_ring_kernel<<<grid, kChannels, smem_bytes(stage), stream>>>(
      h0, S, D, stage, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
}

cudaError_t launch_bwd_ring(const float* a, const float* gh, const float* h,
                            const float* h0, float* da, float* db, float* dh0,
                            int B, int S, int D, int stage,
                            cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rg_scan_bwd_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem_bytes(kStageMax));
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[5];
  if (!(box_map(&maps[0], a, B, S, D, stage) &&
        box_map(&maps[1], gh, B, S, D, stage) &&
        box_map(&maps[2], h, B, S, D, stage) &&
        box_map(&maps[3], da, B, S, D, stage) &&
        box_map(&maps[4], db, B, S, D, stage)))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kBwdChannels - 1) / kBwdChannels),
                  (unsigned)B);
  rg_scan_bwd_ring_kernel<<<grid, kBwdChannels, bwd_smem_bytes(stage),
                            stream>>>(h0, dh0, S, D, stage, maps[0], maps[1],
                                      maps[2], maps[3], maps[4]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h[b, t, :] = a[b, t, :] * h[b, t-1, :] + b[b, t, :], h[b, -1, :] = h0[b]
// (zeros when h0 is null), in blocks of kChannels threads.  Stage 0 runs
// the direct path; any other stage a ring of kStages stages of `stage`
// steps (a multiple of kStep, at most kStageMax), which needs D % 4 == 0
// and 16-byte aligned a, b and h.  The stage comes from the launcher
// (rg_lru.py:scan_geometry); one it does not take returns
// cudaErrorInvalidValue.
int rg_scan_at(const float* a, const float* b, const float* h0, float* h,
               int B, int S, int D, int stage, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535 || stage < 0 || stage > kStageMax || stage % kStep != 0 ||
      (stage > 0 && !wide(D, a, b, h)))
    return (int)cudaErrorInvalidValue;
  if (stage > 0) return (int)launch_ring(a, b, h0, h, B, S, D, stage, stream);
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  rg_scan_kernel<<<grid, kChannels, 0, stream>>>(a, b, h0, h, S, D);
  return (int)cudaGetLastError();
}

// The scan's gradient: da, db [B, S, D] and, when dh0 is not null, dh0
// [B, D] from a, gh = dL/dh and h [B, S, D] and h0 [B, D] (null: zeros).
// Stage 0 runs the direct path (rg_scan_bwd_kernel, blocks of kChannels
// threads); any other stage the ring (rg_scan_bwd_ring_kernel, blocks of
// kBwdChannels) with stages of `stage` steps (a multiple of kStep, at
// most kStageMax), which needs D % 4 == 0 and 16-byte aligned a, gh, h,
// da and db.  The stage comes from the launcher
// (rg_lru.py:scan_bwd_geometry); one it does not take returns
// cudaErrorInvalidValue.
int rg_scan_bwd_at(const float* a, const float* gh, const float* h,
                   const float* h0, float* da, float* db, float* dh0, int B,
                   int S, int D, int stage, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (B > 65535 || stage < 0 || stage > kStageMax || stage % kStep != 0 ||
      (stage > 0 && !wide(D, a, gh, h, da, db)))
    return (int)cudaErrorInvalidValue;
  if (stage > 0)
    return (int)launch_bwd_ring(a, gh, h, h0, da, db, dh0, B, S, D, stage,
                                stream);
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  rg_scan_bwd_kernel<<<grid, kChannels, 0, stream>>>(a, gh, h, h0, da, db,
                                                      dh0, S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
