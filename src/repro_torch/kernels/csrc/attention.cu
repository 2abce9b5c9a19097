// Attention kernels of the serving path for NVIDIA Hopper (sm_90a).
//
// Hand-written replacements of the two Pallas TPU attention kernels:
//
//   att_flash   q [B,S,H,dh], k,v [B,Skv,KH,dh] -> o [B,S,H,dh]
//               forward GQA attention with causal / sliding-window masks
//               (src/repro/kernels/flash_attention.py:71 flash_attention):
//               the prefill's attention (repro_torch/models/kv_cache.py).
//               Skv != S is cross attention (the prompt against an image
//               memory or an encoder's output): non-causal, no window, dh
//               16-128 only (repro computes it with chunked_attention,
//               the flash kernel's jnp twin).
//   att_decode  q [B,H,dh], KV cache k,v [B,L,KH,dh], valid positions
//               [lo, hi) -> o [B,H,dh]
//               (src/repro/kernels/decode_attention.py:56 decode_attention):
//               one query per sequence against the cache, every decode step.
//
// Both read the port's layouts directly (heads inside a position's row,
// as qkv_project and the cache leave them); nothing is transposed.  Query
// head h reads kv head h / (H / KH).  Float32 throughout, plain FMAs on the
// CUDA cores (no tensor cores, no TMA), expf (not __expf), no fast math.
// The masked score is -1e30, as in the Pallas kernels: exp(-1e30 - m) is 0
// for any finite m, and a row that has seen only masked scores carries
// m = -1e30 and is wiped (corr = 0) by its first valid score.
//
// Plain C interface (loaded with ctypes by repro_torch/kernels/build.py):
// every entry point takes device pointers, the sizes and PyTorch's current
// stream, launches on that stream, does not synchronise or allocate, and
// returns cudaGetLastError().  No atomics: both are bitwise the same from
// launch to launch.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 non-tensor):
//   * flash: operations.  4*dh FLOPs per (query, key) pair that the masks
//     keep (QK^T and PV); at B=4, S=2048, H=12, dh=64, causal, 25.8 GFLOP,
//     0.385 ms; its 67 MB of q/k/v/o take 0.02 ms.
//   * decode: bytes.  The K and V read, 2*B*n*KH*dh*4 bytes for n valid
//     positions: 537 MB, 0.160 ms at B=8, n=32768, KH=4, dh=64; 16.8 MB,
//     0.0050 ms at recurrentgemma-2b's B=4, n=2048, KH=1, dh=256.  At the
//     small shapes the two launches' fixed cost and the dh-256 loop's
//     instruction latency, not the bytes, set the time.
//
// Design.
//   * flash: one block per (tile of 64 query rows, query head, batch row);
//     the Pallas grid's sequential kv axis becomes a loop inside the block
//     over key tiles staged in shared memory.  Key tiles wholly outside
//     the causal / window band are skipped -- the only skipped work, and it
//     does not change the result.  Ragged S: loads past S are zero-filled
//     and masked.  At dh 16-128 keys are counted and masked by Skv,
//     queries by S; k and v advance Skv positions a batch row, q and o S
//     (a cross-attention block of 64 query rows walks all Skv keys, the
//     last tile ragged).  Four kernels:
//     - dh 16, 32 (flash_fwd_kernel): 256 threads; rows padded by one
//       float so scalar column reads are conflict-free.  Each thread owns 4
//       query rows x 4 keys of a 64-key score tile and 4 rows x dh/16
//       columns of the accumulator; a row's max and sum reduce over the 16
//       lanes that share it (butterfly shuffles: every lane gets the same
//       bits).  Causal tiles start heaviest first within a head and batch
//       row.
//     - dh 64, 128 (flash_fwd_tiled_kernel): 128 threads as 16 row groups
//       x 8 lanes (ty = t / 8, tx = t % 8).  A thread owns rows ty + 16i
//       (i < 4) x keys tx + 8j (j < 8) of the score tile and the same rows
//       x columns 4 (tx + 8c) .. +3 (c < dh/32) of the accumulator; row max
//       and sum reduce over the 8 lanes of a group (xor 4, 2, 1).  Tiles are
//       row-major, padded to dh + 4 (q, k, v) and 68 (p) floats: rows stay
//       on the 16-byte grid, and a row starts 4 banks after the previous.
//       QK^T walks d by 4: a float4 of q for each of 4 rows and of k for
//       each of 8 keys, 12 16-byte loads for 128 FMAs.  The mapping keeps
//       every such load one shared-memory wavefront: the 8 lanes of a
//       quarter-warp read one q row (broadcast) or 8 key rows 4 banks apart
//       (all 32 banks), and the warp's 4 row groups read the same 8 key rows
//       (broadcast) and 4 q rows 4 banks apart.  PV walks keys by 4: a
//       float4 of p for each row, dh/32 float4s of v for each key (8 lanes
//       on 128 contiguous bytes), 12 loads for 128 FMAs at dh 64.  q, k
//       and v are staged with 16-byte global loads, 8 in flight a tile per
//       thread before the stores, no per-element divides.  The grid is
//       (head, batch row, q tile), x fastest, so the heaviest causal tile
//       row of every head and batch row starts before any lighter one:
//       at B=4 S=2048 the last blocks to start are the lightest, not a
//       late head's 32-tile block.  ptxas (CUDA 12.8): 168 registers at dh
//       64, 167 at dh 128, no spills, so registers and shared memory alike
//       hold three dh-64 blocks (12 warps) on an SM.
//     - dh 256 has two kernels; the launcher picks one by the key span of
//       a block (kernels/flash_attention.py::wide_tiles): the wide kernel
//       where a block of 64 rows sees a whole 256-key tile, the narrow one
//       below that (recurrentgemma-2b's 32-token serve prompt, a short
//       window).  Both use the (head, batch row, q tile) grid above, stage
//       q, k and v with cp.async (16 bytes a copy, L2 only, zero-filled
//       past S) so the next keys land while the current ones are used,
//       keep rows on the 16-byte grid (dh + 4 floats) and take every
//       shared operand in 16-byte loads.  In both, each score is one FMA
//       chain in d order and each output one chain in key order.
//     - dh 256, narrow (flash_fwd_narrow_kernel): 8 warps; warp w owns
//       rows 8w .. 8w + 7, its lanes 4 row lanes x 8 key lanes, so a
//       thread holds 2 rows x 4 keys (kx + 8j) of a 32-key score tile and
//       2 rows x 32 columns (4 (kx + 8c) .. + 3) of the accumulator.  A
//       row's p comes from the 8 lanes of its row lane, so p passes
//       through shared memory under __syncwarp, not a block barrier.  K
//       and V come in 32-key stages, two of them: one __syncthreads a
//       stage, after which the next stage is issued.  A warp none of whose
//       rows sees a key of the stage skips it.  209,920 bytes of shared
//       memory (q, two K/V stages, p), one block an SM; ptxas 194
//       registers, no spills.  Each QK^T step is 6 16-byte loads for 32
//       FMAs, so the kernel is bound by shared-memory loads (PERF.md).
//     - dh 256, wide (flash_fwd_wide_kernel): 512 threads in two groups
//       of 8 warps, warp w of each owning rows 8w .. 8w + 7 of the block's
//       64.  The scorers hold 8 rows x 8 keys (32j + lane) of a 256-key
//       tile a lane; the accumulators 8 rows x 8 columns (4 lane .. + 3,
//       128 + 4 lane .. + 3).  So both products make 16 FMAs per 16-byte
//       load, against 5-8 in the narrow kernel, and neither thread holds
//       both tiles: 128 registers a thread at launch, 136 for the
//       scorers and 120 for the accumulators after setmaxnreg (ptxas,
//       CUDA 12.8: 40 bytes spilled, per-tile scalars outside the FMA
//       loops).  The scorers run QK^T over K chunks of 16 columns x 256
//       keys through a three-slot ring, then the online softmax (full
//       32-lane butterflies), and pass p (64 x 256) and each row's rescale
//       through shared memory; the accumulators run PV over 16-key V
//       chunks through a two-slot ring.  Named barriers: one per group for
//       its ring, and the p tile's empty / full pair, so QK^T of tile
//       t + 1 runs while PV of tile t does.  A warp whose rows see no key
//       of a tile skips it; in a tile it does see, it also computes the
//       32-key chunks its rows cannot see (masked; at most one tile a
//       q tile).  228,608 bytes of shared memory (q, p, the rings, the row
//       statistics), one block an SM.  Measured (PERF.md, Findings): 0.47 of
//       the operations bound at B=4 S=2048; the two groups' times add
//       rather than overlap.
//   * decode: the Pallas grid walks (b, query head) and reads each kv head
//     G = H/KH times; here a block serves the query heads of one kv head
//     (all G of them, or at dh 256 half of recurrentgemma-2b's ten: two
//     blocks of five fit an SM where one of ten did; at dh 128 half of
//     starcoder2's twelve), so the cache is read once, or twice through
//     L2.  Grid: the valid range is cut into
//     splits, one block per (split, head group, batch row) (launch 1), and a
//     second launch combines each head's partial (m, l, acc) in split order.
//     The launcher sizes the splits (decode_attention.py::split_size) to the
//     blocks the card holds at once: att_decode_residency asks the occupancy
//     calculator how many split blocks fit an SM, and the split count is the
//     most that fits residency x 132 in one wave (a partial second wave cost
//     17% at B=8, n=32768), at most 64, each split a whole number of
//     STEP-position iterations.  recurrentgemma-2b's 2048-position ring at
//     B=4 then runs 256 blocks where a 256-position floor gave 32.  Inside a
//     block, dh/4 lanes (dh <= 128) or a full warp with 8 floats a lane (dh
//     256) read one cache row with 16-byte loads; the lane groups take
//     positions round-robin, four (two at dh 256) at a time, with their own
//     online softmax, and are merged in group order through dynamic shared
//     memory (each head's merge weights computed once, by one thread).  An
//     iteration forms every head's partial dot products first and then
//     reduces all of them over the lane group together (group_sums), so
//     their shuffles overlap: at dh 256 the loop is bound by dependent
//     shuffles and expf, not by loads.  The combine takes the splits 8 at a
//     time, loads before arithmetic, in blocks of up to 64 columns.  Tried
//     on the card and removed (PERF.md, Findings): a two-stage cp.async ring
//     of K/V rows (won at dh 64, lost 19% at dh 256), programmatic
//     dependent launch of the combine, issuing the first step's loads before
//     q is staged, and staging the combine's weights in shared memory.
//
// Instantiations: flash at dh 16, 32 (flash_fwd_kernel), 64, 128
// (flash_fwd_tiled_kernel) and 256 (flash_fwd_narrow_kernel through
// att_flash, flash_fwd_wide_kernel through att_flash_wide), any H/KH;
// decode at dh 16-128 with G = H/KH in {1, 2, 3, 4, 6, 8}, at dh 128 also
// G = 5 (qwen2.5-32b, one head group) and 12 (starcoder2, two groups of 6
// heads), and at dh 256 with G = 10 (recurrentgemma-2b's 10 query heads
// over 1 kv head).  Flash
// shared memory: 69,632 bytes at dh 64 (three blocks per SM), 118,784 at
// dh 128 (one), 209,920 (narrow) and 228,608 (wide) at dh 256 (one).  A
// decode block at dh 256 keeps its five heads' q in shared memory (5 x 8
// floats a lane would take 40 registers) beside a 41,280-byte merge
// buffer, 46,400 bytes in all.
// ptxas (CUDA 12.8): 128 registers at dh 256 / G 10 (__launch_bounds__
// asks for two blocks an SM) and 80 at dh 64 / G 3 (three), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ element types
// Every kernel takes q, k, v and o as T = float or bf16 and computes in
// float32 alike: a bf16 element is converted exactly on its way from
// global memory (into registers or into shared memory, which holds
// float32 either way), and each output is rounded once, to nearest even
// (__float2bfloat16_rn).  So a bf16 launch computes what a float32 launch
// computes on the same values, rounded once at the end.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The 4 elements at p (16 bytes of float, 8 of bf16; aligned) as floats.
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(__ldg(p2));
  const float2 b = __bfloat1622float2(__ldg(p2 + 1));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Store 4 outputs at p (aligned), each rounded once to T.
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(bf16* p, float a, float b, float c,
                                    float d) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  p2[1] = __halves2bfloat162(__float2bfloat16_rn(c), __float2bfloat16_rn(d));
}

// ------------------------------------------------------------- flash
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per shared-memory tile

template <int DH>
constexpr int flash_smem_bytes() {
  return (3 * kBQ * (DH + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

// Max / sum over the 16 lanes that share a query row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S,
                 int Skv, int H, int KH, int causal, int window,
                 float scale) {
  static_assert(DH % 16 == 0, "dh must be a multiple of 16");
  constexpr int LD = DH + 1;     // padded row of the q/k/v tiles
  constexpr int PLD = kBK + 1;   // padded row of the probability tile
  constexpr int NC = DH / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][LD]
  float* sK = sQ + kBQ * LD;     // [kBK][LD]
  float* sV = sK + kBK * LD;     // [kBK][LD]
  float* sP = sV + kBK * LD;     // [kBQ][PLD]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kBQ;
  const size_t q_stride = (size_t)H * DH;    // between positions of q / o
  const size_t kv_stride = (size_t)KH * DH;  // between positions of k / v
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * DH;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * DH;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * DH;

  for (int i = threadIdx.x; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    sQ[r * LD + d] =
        q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * q_stride + d]) : 0.0f;
  }

  // keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < Skv;
      const size_t off = (size_t)(k0 + r) * kv_stride + d;
      sK[r * LD + d] = in ? to_f32(kb[off]) : 0.0f;
      sV[r * LD + d] = in ? to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[row][col] += sum_key p[row][key] * v[key][col], keys in order
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * PLD + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = __fmaf_rn(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)qp * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <int DH, typename T>
int launch_flash(const T* q, const T* k, const T* v, T* o, int B, int S,
                 int Skv, int H, int KH, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<DH>();
  // above 48 KB, dynamic shared memory must be asked for (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<DH, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, Skv, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- flash, dh 64 and 128
constexpr int kTileThreads = 128;  // 16 row groups x 8 lanes

template <int DH>
constexpr int flash_tiled_smem_bytes() {
  return (3 * kBQ * (DH + 4) + kBQ * (kBK + 4)) * (int)sizeof(float);
}

// Max / sum over the LG lanes of one lane group (LG a power of two <= 32);
// butterflies, so every lane of the group gets the same bits.
template <int LG>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int LG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[0..3] = the 16 bytes of shared memory at src (16-byte aligned)
__device__ __forceinline__ void lds4(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x;
  dst[1] = t.y;
  dst[2] = t.z;
  dst[3] = t.w;
}

// NT tiles (q; or k and v) of kBQ positions p0.. from HBM into shared
// rows of DH + 4 floats, zero past S.  Thread t moves the float4 at column
// 4 * (t % (DH / 4)) of rows t / (DH / 4) + n * STEP; each pass puts
// 8 loads a tile in flight before its stores.
template <int DH, int NT, typename T>
__device__ __forceinline__ void stage_tiles(float* const (&dst)[NT],
                                            const T* const (&src)[NT],
                                            size_t stride, int p0, int S) {
  constexpr int D4 = DH / 4, STEP = kTileThreads / D4, N = kBQ / STEP;
  constexpr int CH = 8;
  static_assert(N % CH == 0, "passes of CH rows");
  const int r0 = threadIdx.x / D4, c = (threadIdx.x % D4) * 4;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += CH) {
    float4 t[NT][CH];
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int r = r0 + (n0 + n) * STEP;
#pragma unroll
      for (int a = 0; a < NT; ++a)
        t[a][n] = p0 + r < S
                      ? ldg4(src[a] + (size_t)(p0 + r) * stride + c)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int a = 0; a < NT; ++a)
        *reinterpret_cast<float4*>(dst[a] + (r0 + (n0 + n) * STEP) *
                                                (DH + 4) + c) = t[a][n];
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kTileThreads)
flash_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Skv, int H, int KH, int causal, int window,
                       float scale) {
  static_assert(DH == 64 || DH == 128, "the 4 x 8 tile takes dh 64 or 128");
  static_assert(kBQ == kBK, "stage_tiles stages kBQ rows of either tile");
  constexpr int LD = DH + 4;     // padded row of the q/k/v tiles
  constexpr int PLD = kBK + 4;   // padded row of the probability tile
  constexpr int NV = DH / 32;    // float4 column groups of acc per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][LD]
  float* sK = sQ + kBQ * LD;     // [kBK][LD]
  float* sV = sK + kBK * LD;     // [kBK][LD]
  float* sP = sV + kBK * LD;     // [kBQ][PLD]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int q0 = qt * kBQ;
  const size_t q_stride = (size_t)H * DH;    // between positions of q / o
  const size_t kv_stride = (size_t)KH * DH;  // between positions of k / v
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * DH;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * DH;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * DH;
  float* const kv_dst[2] = {sK, sV};
  const T* const kv_src[2] = {kb, vb};

  {
    float* const dst[1] = {sQ};
    const T* const src[1] = {qb};
    stage_tiles<DH, 1>(dst, src, q_stride, q0, S);
  }

  // keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  // rows ty + 16i; keys tx + 8j; acc columns 4 * (tx + 8c) + e
  float m[4], l[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_tiles<DH, 2>(kv_dst, kv_src, kv_stride, k0, Skv);
    __syncthreads();

    // s[i][j] = q[row i] . k[key j], one FMA per d in d order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float qv[4][4], kv[8][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds4(qv[i], sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) lds4(kv[j], sK + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s[i][j] = __fmaf_rn(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<8>(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * PLD + tx + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + group_sum<8>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[row][col] += sum_key p[row][key] * v[key][col], keys in order
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds4(p[i], sP + (ty + 16 * i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[4 * NV];
#pragma unroll
        for (int c = 0; c < NV; ++c)
          lds4(vv + 4 * c, sV + (kk + u) * LD + 4 * (tx + 8 * c));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4 * NV; ++c)
            acc[i][c] = __fmaf_rn(p[i][u], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NV; ++c)
      st4(ob + (size_t)qp * q_stride + 4 * (tx + 8 * c), acc[i][4 * c] / denom,
          acc[i][4 * c + 1] / denom, acc[i][4 * c + 2] / denom,
          acc[i][4 * c + 3] / denom);
  }
}

template <int DH, typename T>
int launch_flash_tiled(const T* q, const T* k, const T* v, T* o, int B,
                       int S, int Skv, int H, int KH, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr int smem = flash_tiled_smem_bytes<DH>();
  // above 48 KB, dynamic shared memory must be asked for (per device); the
  // largest carveout is asked for so that three dh-64 blocks (3 x 69,632
  // bytes) fit an SM whatever carveout CUDA would pick by default
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tiled_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_tiled_kernel<DH, T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;  // grid z's limit
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
  flash_fwd_tiled_kernel<DH, T><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, o, S, Skv, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- flash, dh 256: shared
constexpr int kDH256 = 256;

// Asynchronous 16-byte copy global -> shared (cp.async, L2 only); the 16
// bytes are zero-filled instead where `in` is false (src is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 elements global -> 4 floats of shared memory (16-byte aligned), zero
// where `in` is false: a cp.async for float; for bf16, which cp.async
// cannot convert, a plain load, converted, then a shared store, done
// before the function returns (the commit / wait calls around it then
// have nothing to wait for).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  cp_async16(dst, src, in);
}
__device__ __forceinline__ void copy4(float* dst, const bf16* src, bool in) {
  *reinterpret_cast<float4*>(dst) =
      in ? ldg4(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Named barrier `id` over n threads: wait for all of them, or only arrive.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------- flash, dh 256, short key spans (narrow)
// 8 warps; a warp owns 8 query rows, its lanes 4 row lanes x 8 key lanes.
constexpr int kNarrowThreads = 256;
constexpr int kNarrowBK = 32;       // keys per K/V stage
constexpr int kNarrowStages = 2;    // K/V stages: tile t + 1 lands during t
constexpr int kNarrowPLD = kNarrowBK + 8;  // row of the probability tile

constexpr int flash_narrow_smem_bytes() {
  return (kBQ * (kDH256 + 4) + kNarrowStages * 2 * kNarrowBK * (kDH256 + 4) +
          kBQ * kNarrowPLD) * (int)sizeof(float);
}

// NR positions p0.. of one head (rows `stride` floats apart in HBM) into
// shared rows of 260 floats, zero past S: thread t copies the float4s
// t + n * kNarrowThreads, 64 consecutive threads to a row.
template <int NR, typename T>
__device__ __forceinline__ void narrow_stage(float* dst, const T* src,
                                             size_t stride, int p0, int S) {
  constexpr int D4 = kDH256 / 4;
  static_assert((NR * D4) % kNarrowThreads == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < NR * D4 / kNarrowThreads; ++n) {
    const int i = (int)threadIdx.x + n * kNarrowThreads;
    const int r = i / D4, c = (i % D4) * 4;
    const bool in = p0 + r < S;
    copy4(dst + r * (kDH256 + 4) + c,
          src + (size_t)(in ? p0 + r : 0) * stride + c, in);
  }
}

template <typename T>
__global__ void __launch_bounds__(kNarrowThreads, 1)
flash_fwd_narrow_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int S,
                        int H, int KH, int causal, int window, float scale) {
  constexpr int DH = kDH256, LD = DH + 4;  // padded row of the q/k/v tiles
  constexpr int NV = DH / 32;    // float4 column groups of acc per thread
  constexpr int KV = 2 * kNarrowBK * LD;  // one stage: K then V
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* sKV = sQ + kBQ * LD;      // [stage][K, V][kNarrowBK][LD]
  float* sP = sKV + kNarrowStages * KV;  // [kBQ][kNarrowPLD]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ry = lane >> 3, kx = lane & 7;
  const int q0 = qt * kBQ;
  const int r0 = 8 * warp + ry;  // the thread's tile rows r0 and r0 + 4
  const int w0 = q0 + 8 * warp;  // the warp's first position
  const int w_last = min(w0 + 7, S - 1);  // and last valid (< w0: none)
  const size_t q_stride = (size_t)H * DH;    // between positions of q / o
  const size_t kv_stride = (size_t)KH * DH;  // between positions of k / v
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * DH;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * DH;

  // key tiles any row of this block may see: [t_begin, t_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kNarrowBK;
  const int t_end = (k_end + kNarrowBK - 1) / kNarrowBK;

  narrow_stage<kBQ>(sQ, qb, q_stride, q0, S);
  narrow_stage<kNarrowBK>(sKV, kb, kv_stride, t_begin * kNarrowBK, S);
  narrow_stage<kNarrowBK>(sKV + kNarrowBK * LD, vb, kv_stride,
                          t_begin * kNarrowBK, S);
  cp_async_commit();

  // rows r0 + 4i; keys kx + 8j; acc columns 4 * (kx + 8c) + e
  float m[2], l[2], acc[2][4 * NV];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const float* sK = sKV + ((t - t_begin) % kNarrowStages) * KV;
    const float* sV = sK + kNarrowBK * LD;
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every reader of tile t - 1 is done
    if (t + 1 < t_end) {  // tile t + 1 into the stage tile t - 1 left
      float* nK = sKV + ((t + 1 - t_begin) % kNarrowStages) * KV;
      narrow_stage<kNarrowBK>(nK, kb, kv_stride, (t + 1) * kNarrowBK, S);
      narrow_stage<kNarrowBK>(nK + kNarrowBK * LD, vb, kv_stride,
                              (t + 1) * kNarrowBK, S);
    }
    cp_async_commit();
    const int k0 = t * kNarrowBK;
    // a warp none of whose rows sees a key of the tile skips it: exactly
    // what the tile would add (a row with no score yet is wiped later)
    bool live = w0 <= w_last;
    if (causal) live = live && k0 <= w_last;
    if (window > 0) live = live && k0 + kNarrowBK - 1 > w0 - window;
    if (!live) continue;

    // s[i][j] = q[row i] . k[key j], one FMA per d in d order
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float qv[2][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) lds4(qv[i], sQ + (r0 + 4 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) lds4(kv[j], sK + (kx + 8 * j) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = __fmaf_rn(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + r0 + 4 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + kx + 8 * j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<8>(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(r0 + 4 * i) * kNarrowPLD + kx + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + group_sum<8>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's p comes from the 8 lanes of its row lane

    // acc[row][col] += sum_key p[row][key] * v[key][col], keys in order
#pragma unroll 2
    for (int kk = 0; kk < kNarrowBK; kk += 4) {
      float p[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lds4(p[i], sP + (r0 + 4 * i) * kNarrowPLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[4 * NV];
#pragma unroll
        for (int c = 0; c < NV; ++c)
          lds4(vv + 4 * c, sV + (kk + u) * LD + 4 * (kx + 8 * c));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4 * NV; ++c)
            acc[i][c] = __fmaf_rn(p[i][u], vv[c], acc[i][c]);
      }
    }
  }
  cp_async_wait<0>();  // no copy may be in flight when the block exits

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 4 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NV; ++c)
      st4(ob + (size_t)qp * q_stride + 4 * (kx + 8 * c), acc[i][4 * c] / denom,
          acc[i][4 * c + 1] / denom, acc[i][4 * c + 2] / denom,
          acc[i][4 * c + 3] / denom);
  }
}

template <typename T>
int launch_flash_narrow(const T* q, const T* k, const T* v, T* o, int B,
                        int S, int H, int KH, int causal, int window,
                        float scale, cudaStream_t stream) {
  constexpr int smem = flash_narrow_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_narrow_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;  // grid z's limit
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
  flash_fwd_narrow_kernel<T><<<grid, kNarrowThreads, smem, stream>>>(
      q, k, v, o, S, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------- flash, dh 256, long key spans (wide)
// Two warp groups of 8 warps share a block's 64 query rows, warp w of
// each taking rows 8w .. 8w + 7: the scorers hold 8 x 8 scores a lane
// (keys 32j + lane of a 256-key tile), the accumulators 8 x 8 outputs a
// lane (columns 4 lane .. + 3 and 128 + 4 lane .. + 3).  The probability
// tile passes between them through shared memory.
constexpr int kWideRows = 8;                  // query rows of a warp
constexpr int kWideWarps = kBQ / kWideRows;   // warps of a group
constexpr int kWideGroup = 32 * kWideWarps;   // threads of a group
constexpr int kWideThreads = 2 * kWideGroup;
constexpr int kWideBK = 256;                  // keys per tile
constexpr int kWideLD = kDH256 + 4;           // padded row of q, p and v
constexpr int kWideKLD = 16 + 4;              // row of a K chunk: 16 columns
constexpr int kWideKSlot = kWideBK * kWideKLD;  // K chunk: 256 keys
constexpr int kWideVSlot = 16 * kWideLD;      // V chunk: 16 keys
// named barriers (0 is __syncthreads): each group's ring, the
// probability tile's two states, and the final row sums
constexpr int kBarK = 1, kBarV = 2, kBarPEmpty = 3, kBarPFull = 4,
              kBarDone = 5;

// Shared memory, in floats from its start: q [kBQ][kWideLD], p of a tile
// [kBQ][kWideLD], the K ring [3][kWideKSlot], the V ring [2][kWideVSlot],
// and per row the running max, the running sum and a tile's rescale.
constexpr int kWideP = kBQ * kWideLD, kWideK = 2 * kBQ * kWideLD,
              kWideV = kWideK + 3 * kWideKSlot,
              kWideM = kWideV + 2 * kWideVSlot, kWideL = kWideM + kBQ,
              kWideC = kWideL + kBQ;

constexpr int flash_wide_smem_bytes() {
  return (kWideC + kBQ) * (int)sizeof(float);
}

// The 32-key chunks of tile t that some row of the block sees,
// [lo, lo + n) of its 8.  The tile's K arrives in 16 chunks of 16
// columns of the 256 keys from k0 + 32 lo (those past the visible chunks
// are not read), its V in 2n chunks of 16 keys.
struct WideTile {
  int k0, lo, n;
};

__device__ __forceinline__ WideTile wide_tile(int t, int k_begin,
                                              int k_end) {
  WideTile w;
  w.k0 = t * kWideBK;
  w.lo = max(0, k_begin - w.k0) >> 5;
  w.n = (min(kWideBK, k_end - w.k0 + 31) >> 5) - w.lo;
  return w;
}

// K chunk `idx` of tile t into a slot, 1024 float4 copies over the scorers:
// columns [16 idx, +16) of keys k0 + 32 lo .. + 255, rows of kWideKLD;
// keys past the visible chunks or k_end are zero-filled.
template <typename T>
__device__ __forceinline__ void wide_issue_k(float* slot, const T* kb,
                                             size_t stride, int t, int idx,
                                             int k_begin, int k_end,
                                             int tid) {
  const WideTile w = wide_tile(t, k_begin, k_end);
  const int kin = min(k_end, w.k0 + 32 * (w.lo + w.n));
#pragma unroll
  for (int m = 0; m < 1024 / kWideGroup; ++m) {
    const int f = tid + m * kWideGroup;
    const int r = f >> 2, c = (f & 3) * 4;
    const int key = w.k0 + 32 * w.lo + r;
    const bool in = key < kin;
    copy4(slot + r * kWideKLD + c,
          kb + (size_t)(in ? key : 0) * stride + 16 * idx + c, in);
  }
}

// V chunk `idx` of tile t (keys k0 + 32 lo + 16 idx ..  + 15, rows of
// kWideLD floats) into a slot, 1024 float4 copies over the accumulators.
template <typename T>
__device__ __forceinline__ void wide_issue_v(float* slot, const T* vb,
                                             size_t stride, int t, int idx,
                                             int k_begin, int k_end,
                                             int tid) {
  const WideTile w = wide_tile(t, k_begin, k_end);
#pragma unroll
  for (int m = 0; m < 1024 / kWideGroup; ++m) {
    const int f = tid + m * kWideGroup;
    const int r = f >> 6, c = (f & 63) * 4;
    const int key = w.k0 + 32 * w.lo + 16 * idx + r;
    const bool in = key < k_end;
    copy4(slot + r * kWideLD + c, vb + (size_t)(in ? key : 0) * stride + c,
          in);
  }
}

// What a block's warp of either group knows of its rows and keys.
template <typename T>
struct WideBlock {
  int S, causal, window;
  float scale;
  size_t kv_stride;
  const T *kb, *vb;      // this batch row's kv head
  int k_begin, k_end;    // keys any row of the block sees
  int t_begin, t_end;    // its tiles
  int q0;                // the block's first position
  int w0;                // the warp's first position
  int tid, lane, warp;   // within the group
};

// Whether the warp's rows see a key of the tile's visible chunks, keys
// [kc, kc + 32 n); a warp that sees none skips the tile: exactly what the
// tile would add (a row with no score yet is wiped by its first one).
template <typename T>
__device__ __forceinline__ bool wide_live(const WideBlock<T>& B,
                                          const WideTile& w) {
  const int kc = w.k0 + 32 * w.lo;
  const int last = min(B.w0 + kWideRows - 1, B.S - 1);  // its last row
  return B.w0 <= last &&
         (B.window <= 0 || B.w0 - B.window < kc + 32 * w.n - 1) &&
         (!B.causal || last >= kc);
}

// s[i][j] += q[row i] . k[key 32j + lane] over a K chunk's 16 columns,
// one FMA per d in d order, for the tile's first n
// chunks of 32 keys (ALL: all 8), two keys' float4s at a time.
template <bool ALL>
__device__ __forceinline__ void wide_qk(float (&s)[kWideRows][8],
                                        const float* qc, const float* sK,
                                        int lane, int n) {
  constexpr int LDK = kWideKLD;
  const float* kl = sK + lane * LDK;
#pragma unroll 2
  for (int d = 0; d < 16; d += 4) {
    float qv[kWideRows][4], kv[2][4];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) lds4(qv[i], qc + i * kWideLD + d);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (!ALL && j >= n) continue;
      lds4(kv[0], kl + 32 * j * LDK + d);
      lds4(kv[1], kl + 32 * (j + 1) * LDK + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) {
          s[i][j] = __fmaf_rn(qv[i][e], kv[0][e], s[i][j]);
          s[i][j + 1] = __fmaf_rn(qv[i][e], kv[1][e], s[i][j + 1]);
        }
    }
  }
}

// The scorers: for every tile, s = q k^T over the K ring, then the online
// softmax, p into the shared tile and each row's rescale into sC.
template <typename T>
__device__ __forceinline__ void wide_scores(const WideBlock<T>& B,
                                            float* smem) {
  constexpr int LD = kWideLD;
  const float* sQ = smem;
  float *sP = smem + kWideP, *kring = smem + kWideK, *sM = smem + kWideM,
        *sL = smem + kWideL, *sC = smem + kWideC;
  const int lane = B.lane, warp = B.warp;
  float* sPw = sP + kWideRows * warp * LD;
  // three K slots: chunk c is computed while c + 1 and c + 2 land.  The
  // kernel issued chunk 0 of the first tile into slot 0
  wide_issue_k(kring + kWideKSlot, B.kb, B.kv_stride, B.t_begin, 1,
               B.k_begin, B.k_end, B.tid);
  cp_async_commit();
  for (int t = B.t_begin; t < B.t_end; ++t) {
    const WideTile w = wide_tile(t, B.k_begin, B.k_end);
    const bool live = wide_live(B, w);
    const int kc = w.k0 + 32 * w.lo;
    float s[kWideRows][8];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < 16; ++c) {
      // chunk c of tile t is the (16 (t - t_begin) + c)-th: its slot
      const int slot = (t - B.t_begin + c) % 3;
      cp_async_wait<1>();
      bar_sync(kBarK, kWideGroup);  // chunk c is in; the slot of c - 1
                                    // has no reader left
      // chunk c + 2: of this tile, or the next's
      const bool here = c + 2 < 16;
      const int tn = here ? t : t + 1;
      if (tn < B.t_end)
        wide_issue_k(kring + (slot + 2) % 3 * kWideKSlot, B.kb, B.kv_stride,
                     tn, here ? c + 2 : c - 14, B.k_begin, B.k_end, B.tid);
      cp_async_commit();
      if (!live) continue;
      const float* sK = kring + slot * kWideKSlot;
      const float* qc = sQ + kWideRows * warp * LD + 16 * c;
      if (w.n == 8)
        wide_qk<true>(s, qc, sK, lane, 8);
      else
        wide_qk<false>(s, qc, sK, lane, w.n);
    }
    // the accumulators are done with the previous tile's p.  A warp that
    // is not live runs this too, in step with the others: with no chunk
    // of its own it writes no p, and m and l come out unchanged
    bar_sync(kBarPEmpty, kWideThreads);
    {
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) {
        const int qp = B.w0 + i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kp = kc + 32 * j + lane;
          bool ok = live && j < w.n && kp < B.S;
          if (B.causal) ok = ok && kp <= qp;
          if (B.window > 0) ok = ok && kp > qp - B.window;
          s[i][j] = ok ? s[i][j] * B.scale : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_old = sM[kWideRows * warp + i];
        const float m_new = fmaxf(m_old, group_max<32>(mx));
        const float corr = expf(m_old - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!live || j >= w.n) continue;
          const float p = expf(s[i][j] - m_new);
          sPw[i * LD + 32 * j + lane] = p;
          sum += p;
        }
        const float l_new =
            sL[kWideRows * warp + i] * corr + group_sum<32>(sum);
        __syncwarp();  // every lane has read the row's sM and sL
        if (lane == 0) {
          sM[kWideRows * warp + i] = m_new;
          sL[kWideRows * warp + i] = l_new;
          sC[kWideRows * warp + i] = corr;
        }
      }
    }
    bar_arrive(kBarPFull, kWideThreads);
  }
}

// The accumulators: for every tile, rescale by sC, then acc += p v over the
// V ring; at the end, the outputs of the warp's rows.
template <typename T>
__device__ __forceinline__ void wide_outputs(const WideBlock<T>& B,
                                             float* smem, T* ob,
                                             size_t q_stride) {
  constexpr int LD = kWideLD;
  const float *sP = smem + kWideP, *sL = smem + kWideL, *sC = smem + kWideC;
  float* vring = smem + kWideV;
  const int lane = B.lane, warp = B.warp;
  const float* sPw = sP + kWideRows * warp * LD;
  float acc[kWideRows][8];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i)
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[i][x] = 0.0f;
  int slot = 0;
  for (int t = B.t_begin; t < B.t_end; ++t) {
    const WideTile w = wide_tile(t, B.k_begin, B.k_end);
    const bool live = wide_live(B, w);
    bar_sync(kBarPFull, kWideThreads);
    if (live) {
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) {
        const float corr = sC[kWideRows * warp + i];
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[i][x] *= corr;
      }
    }
    for (int idx = 0; idx < 2 * w.n; ++idx, slot ^= 1) {
      cp_async_wait<0>();
      bar_sync(kBarV, kWideGroup);
      const bool here = idx + 1 < 2 * w.n;  // chunk idx + 1, or the next
      const int tn = here ? t : t + 1;       // tile's first
      if (tn < B.t_end)
        wide_issue_v(vring + (slot ^ 1) * kWideVSlot, B.vb, B.kv_stride, tn,
                     here ? idx + 1 : 0, B.k_begin, B.k_end, B.tid);
      cp_async_commit();
      if (!live) continue;
      // acc[row][col] += sum_key p[row][key] * v[key][col] over V's 16
      // keys, keys in order
      const float* sV = vring + slot * kWideVSlot;
      const float* pc = sPw + 16 * idx;
#pragma unroll 4
      for (int kk = 0; kk < 16; kk += 2) {
        float2 p[kWideRows];
#pragma unroll
        for (int i = 0; i < kWideRows; ++i)
          p[i] = *reinterpret_cast<const float2*>(pc + i * LD + kk);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float vv[8];
          lds4(vv, sV + (kk + u) * LD + 4 * lane);
          lds4(vv + 4, sV + (kk + u) * LD + 128 + 4 * lane);
#pragma unroll
          for (int i = 0; i < kWideRows; ++i)
#pragma unroll
            for (int x = 0; x < 8; ++x)
              acc[i][x] = __fmaf_rn(u ? p[i].y : p[i].x, vv[x], acc[i][x]);
        }
      }
    }
    if (t + 1 < B.t_end) bar_arrive(kBarPEmpty, kWideThreads);
  }
  cp_async_wait<0>();
  bar_sync(kBarDone, kWideThreads);  // the scorers' row sums are final
#pragma unroll
  for (int i = 0; i < kWideRows; ++i) {
    const int qp = B.w0 + i;
    if (qp >= B.S) continue;
    const float denom = fmaxf(sL[kWideRows * warp + i], 1e-20f);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      st4(ob + (size_t)qp * q_stride + 128 * e + 4 * lane,
          acc[i][4 * e] / denom, acc[i][4 * e + 1] / denom,
          acc[i][4 * e + 2] / denom, acc[i][4 * e + 3] / denom);
  }
}

// The launch's view of one warp of either group (blockIdx, threadIdx).
template <typename T>
__device__ __forceinline__ WideBlock<T> wide_block(const T* k, const T* v,
                                                   int S, int H, int KH,
                                                   int causal, int window,
                                                   float scale) {
  WideBlock<T> B;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kBQ;  // heaviest first
  const int kvh = (int)blockIdx.x / (H / KH);
  B.S = S;
  B.causal = causal;
  B.window = window;
  B.scale = scale;
  B.kv_stride = (size_t)KH * kDH256;  // between positions of k / v
  B.kb = k + (size_t)blockIdx.y * S * B.kv_stride + (size_t)kvh * kDH256;
  B.vb = v + (size_t)blockIdx.y * S * B.kv_stride + (size_t)kvh * kDH256;
  B.tid = threadIdx.x & (kWideGroup - 1);
  B.lane = B.tid & 31;
  B.warp = B.tid >> 5;
  B.q0 = q0;
  B.w0 = q0 + kWideRows * B.warp;
  B.k_end = causal ? min(q0 + kBQ, S) : S;
  B.k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  B.t_begin = B.k_begin / kWideBK;
  B.t_end = (B.k_end + kWideBK - 1) / kWideBK;
  return B;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int H, int KH, int causal, int window, float scale) {
  constexpr int LD = kWideLD;
  static_assert(kBQ == kWideRows * kWideWarps, "whole warps of rows");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t q_stride = (size_t)H * kDH256;    // between positions of q, o
  const size_t bh = (size_t)blockIdx.y * S * q_stride + blockIdx.x * kDH256;

  // 128 registers a thread at launch; the scorers take 136 (64 scores, q
  // and k fragments), the accumulators give up 8 (64 outputs, p and v
  // fragments need fewer).  setmaxnreg counts in multiples of 8.
  if (threadIdx.x < kWideGroup) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 136;\n" ::);
    const WideBlock<T> B = wide_block(k, v, S, H, KH, causal, window, scale);
#pragma unroll
    for (int m = 0; m < kBQ * kDH256 / 4 / kWideGroup; ++m) {
      const int f = B.tid + m * kWideGroup;
      const int r = f >> 6, c = (f & 63) * 4;
      const bool in = B.q0 + r < S;
      copy4(smem + r * LD + c,
            q + bh + (size_t)(in ? B.q0 + r : 0) * q_stride + c, in);
    }
    wide_issue_k(smem + kWideK, B.kb, B.kv_stride, B.t_begin, 0, B.k_begin,
                 B.k_end, B.tid);
    cp_async_commit();
    if (B.lane < kWideRows) {
      smem[kWideM + kWideRows * B.warp + B.lane] = kNegInf;
      smem[kWideL + kWideRows * B.warp + B.lane] = 0.0f;
    }
    wide_scores(B, smem);
    cp_async_wait<0>();  // no copy may be in flight when a thread exits
    bar_arrive(kBarDone, kWideThreads);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::);
    const WideBlock<T> B = wide_block(k, v, S, H, KH, causal, window, scale);
    wide_issue_v(smem + kWideV, B.vb, B.kv_stride, B.t_begin, 0,
                 B.k_begin, B.k_end, B.tid);
    cp_async_commit();
    bar_arrive(kBarPEmpty, kWideThreads);  // the probability tile is free
    wide_outputs(B, smem, o + bh, q_stride);
  }
}

template <typename T>
int launch_flash_wide(const T* q, const T* k, const T* v, T* o, int B, int S,
                      int H, int KH, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int smem = flash_wide_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;  // grid z's limit
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
  flash_fwd_wide_kernel<T><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, o, S, H, KH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ decode
// Lane mapping of a cache row: VEC floats per lane (16-byte loads), LG
// lanes per row, U positions per lane group per step, STEP = NGR * U
// positions per block iteration.  Up to dh 128 a lane takes 4 floats; at
// dh 256 a full warp takes a row, 8 floats a lane, and two positions a
// step (fewer registers for the G = 10 accumulators).  The launcher's
// STEPS table (kernels/decode_attention.py) mirrors STEP.
template <int DH>
struct DecodeMap {
  static constexpr int VEC = DH > 128 ? 8 : 4;
  static constexpr int LG = DH / VEC;
  static constexpr int NGR = kThreads / LG;  // lane groups per block
  static constexpr int U = VEC == 8 ? 2 : 4;
  static constexpr int STEP = NGR * U;
};

// Blocks a kv head's G query heads are shared among: two at dh 256, five
// heads each (a warp's 8 columns of 10 heads' accumulators would hold one
// block an SM by registers; 5 heads let two run), and two past 8 heads
// (starcoder2's 12 at dh 128: 12 heads' q would go to shared memory and
// their merge arrays past 48 KB; two blocks of 6 keep q in registers and
// take a G = 6 block's 24,960 bytes, and the second block's read of the
// kv head's K/V rows is the first's, a few microseconds later, from L2),
// else one.  The launcher's HEAD_GROUPS (kernels/decode_attention.py)
// mirrors it.
template <int DH, int G>
__host__ __device__ constexpr int decode_head_groups() {
  return DH > 128 || G > 8 ? 2 : 1;
}

// q lives in shared memory when a block's GB = G / head groups heads'
// slices would take more than 32 registers a thread (dh 256); otherwise
// in registers.
template <int DH, int G>
__host__ __device__ constexpr bool decode_q_shared() {
  return G / decode_head_groups<DH, G>() * DecodeMap<DH>::VEC > 32;
}

// Blocks an SM the registers must allow: three (80 registers a thread)
// where a block's GB heads are few at dh <= 128 (flaas-100m's G = 3), two
// at dh 256 (128 registers), otherwise what ptxas needs.
template <int DH, int G>
__host__ __device__ constexpr int decode_min_blocks() {
  return DH > 128 ? 2 : G / decode_head_groups<DH, G>() <= 3 ? 3 : 1;
}

// Dynamic shared memory of one decode block: q (when shared), then each
// lane group's (acc[GB][DH], m[GB], l[GB]) for the in-order merge; at
// most 46,400 bytes (dh 256), so no instantiation needs more than the
// 48 KB a launch gets without asking.
template <int DH, int G>
constexpr int decode_smem_bytes() {
  constexpr int GB = G / decode_head_groups<DH, G>();
  return ((decode_q_shared<DH, G>() ? GB * DH : 0) +
          DecodeMap<DH>::NGR * GB * (DH + 2)) * (int)sizeof(float);
}

template <int VEC, typename T>
__device__ __forceinline__ void load_vec(float (&dst)[VEC], const T* src) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 t = ldg4(src + e);
    dst[e] = t.x;
    dst[e + 1] = t.y;
    dst[e + 2] = t.z;
    dst[e + 3] = t.w;
  }
}

// group_sum<LG> of every v[g][u] at once: the same butterflies, level by
// level across all of them, so the shuffles of independent sums overlap
// instead of running head by head.
template <int LG, int G, int U>
__device__ __forceinline__ void group_sums(float (&v)[G][U]) {
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[g][u] += __shfl_xor_sync(0xffffffffu, v[g][u], off);
}

// Launch 1: block (split, head group of a kv head, batch row) -> each of
// its GB query heads' (m, l, acc[dh]) over positions
// [lo + split*sp, ... + split) n [lo, hi).
template <int DH, int G, typename T>
__global__ void __launch_bounds__(kThreads, decode_min_blocks<DH, G>())
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int L, int KH, int lo, int hi, int split, float scale) {
  using Map = DecodeMap<DH>;
  constexpr int VEC = Map::VEC, LG = Map::LG, NGR = Map::NGR, U = Map::U;
  constexpr int HG = decode_head_groups<DH, G>(), GB = G / HG;
  constexpr bool kQShared = decode_q_shared<DH, G>();
  static_assert(DH % VEC == 0 && LG <= 32 && (32 % LG) == 0, "unsupported dh");
  static_assert(G % HG == 0, "head groups must split G evenly");
  extern __shared__ float smem[];
  float* sm_q = smem;                                       // [GB][DH]
  float* sm_acc = sm_q + (kQShared ? GB * DH : 0);          // [NGR][GB][DH]
  float* sm_m = sm_acc + NGR * GB * DH;                     // [NGR][GB]
  float* sm_l = sm_m + NGR * GB;                            // [NGR][GB]

  // blockIdx.y = kv head * HG + head group; its heads start at y * GB
  const int sp = blockIdx.x, kvh = blockIdx.y / HG, b = blockIdx.z;
  const int nsplit = gridDim.x, H = KH * G;
  const int li = threadIdx.x % LG, gi = threadIdx.x / LG;
  const int start = lo + sp * split;
  const int end = min(hi, start + split);
  const size_t bh0 = (size_t)b * H + (size_t)blockIdx.y * GB;  // first head
  const T* qb = q + bh0 * DH;                                   // GB rows

  float qreg[kQShared ? 1 : GB][VEC];
  if constexpr (kQShared) {
    for (int i = threadIdx.x; i < GB * DH; i += kThreads)
      sm_q[i] = to_f32(qb[i]);
    __syncthreads();
  } else {
#pragma unroll
    for (int g = 0; g < GB; ++g) load_vec<VEC>(qreg[g], qb + g * DH + li * VEC);
  }

  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }

  const size_t row = (size_t)KH * DH;  // between positions of the cache
  const T* kb = k + (size_t)b * L * row + (size_t)kvh * DH + li * VEC;
  const T* vb = v + (size_t)b * L * row + (size_t)kvh * DH + li * VEC;
  // the trip count is the block's, so every lane reaches the shuffles
  for (int it = start; it < end; it += Map::STEP) {
    const int base = it + gi;
    float kk[U][VEC], vv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + NGR * u;
      if (p < end) {
        load_vec<VEC>(kk[u], kb + (size_t)p * row);
        load_vec<VEC>(vv[u], vb + (size_t)p * row);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kk[u][e] = vv[u][e] = 0.0f;
      }
    }
    // every head's dot products first, then all GB*U lane-group sums at once
    float s[GB][U];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float qv[VEC];
      if constexpr (kQShared) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          lds4(&qv[e], sm_q + g * DH + li * VEC + e);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[e] = qreg[g][e];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = qv[0] * kk[u][0];
#pragma unroll
        for (int e = 1; e < VEC; ++e) d = __fmaf_rn(qv[e], kk[u][e], d);
        s[g][u] = d;
      }
    }
    group_sums<LG>(s);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = base + NGR * u < end ? s[g][u] * scale : kNegInf;
        mx = fmaxf(mx, s[g][u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a position past `end` adds exactly nothing (what exp(-1e30 - m)
        // gives once m is a real score)
        const float p = base + NGR * u < end ? expf(s[g][u] - m_new) : 0.0f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = __fmaf_rn(p, vv[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // merge the lane groups in group order (a group with no position has
  // m = -1e30, l = 0, acc = 0 and adds exactly nothing)
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (li == 0) {
      sm_m[gi * GB + g] = m[g];
      sm_l[gi * GB + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[(gi * GB + g) * DH + li * VEC + e] = acc[g][e];
  }
  __syncthreads();
  // thread g < GB: head g's max, its sum and its weights exp(m_r - max),
  // each computed once, in place of the m_r
  if (threadIdx.x < GB) {
    const int g = threadIdx.x;
    float mm = kNegInf;
    for (int r = 0; r < NGR; ++r) mm = fmaxf(mm, sm_m[r * GB + g]);
    float ll = 0.0f;
    for (int r = 0; r < NGR; ++r) {
      const float w = expf(sm_m[r * GB + g] - mm);
      ll = __fmaf_rn(sm_l[r * GB + g], w, ll);
      sm_m[r * GB + g] = w;
    }
    part_m[(bh0 + g) * nsplit + sp] = mm;
    part_l[(bh0 + g) * nsplit + sp] = ll;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < GB * DH; t += kThreads) {
    const int g = t / DH, d = t % DH;
    float aa = 0.0f;
    for (int r = 0; r < NGR; ++r)
      aa = __fmaf_rn(sm_acc[(r * GB + g) * DH + d], sm_m[r * GB + g], aa);
    part_acc[((bh0 + g) * nsplit + sp) * DH + d] = aa;
  }
}

// Launch 2: block (query head, batch row, chunk of up to 64 columns), one
// thread per output column: merge the head's splits in order and
// normalise.  A thread takes the splits 8 at a time, their loads issued
// together before any of their arithmetic; the column chunks spread a
// dh-256 head over 4 blocks (both cut the launch; PERF.md, Findings).
constexpr int kCombineChunk = 8;

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, int H, int nsplit,
                                      int dh) {
  constexpr int CH = kCombineChunk;
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  const float* pa = part_acc + bh * nsplit * dh;
  for (int d = blockIdx.z * blockDim.x + threadIdx.x; d < dh;
       d += gridDim.z * blockDim.x) {
    float mm = kNegInf;
    for (int s0 = 0; s0 < nsplit; s0 += CH) {
      float xm[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        xm[j] = s0 + j < nsplit ? pm[s0 + j] : kNegInf;
#pragma unroll
      for (int j = 0; j < CH; ++j) mm = fmaxf(mm, xm[j]);
    }
    float ll = 0.0f, aa = 0.0f;
    for (int s0 = 0; s0 < nsplit; s0 += CH) {
      float xm[CH], xl[CH], xa[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const bool in = s0 + j < nsplit;
        xm[j] = in ? pm[s0 + j] : kNegInf;
        xl[j] = in ? pl[s0 + j] : 0.0f;
        xa[j] = in ? pa[(size_t)(s0 + j) * dh + d] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (s0 + j < nsplit) {
          const float w = expf(xm[j] - mm);
          ll = __fmaf_rn(xl[j], w, ll);
          aa = __fmaf_rn(xa[j], w, aa);
        }
      }
    }
    o[bh * dh + d] = from_f32<T>(aa / fmaxf(ll, 1e-20f));
  }
}

// Blocks of decode_split_kernel<DH, G> resident on one SM (registers,
// shared memory and threads), or -cudaError_t.
template <int DH, int G, typename T>
int decode_residency() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_split_kernel<DH, G, T>, kThreads, decode_smem_bytes<DH, G>());
  return err != cudaSuccess ? -(int)err : n;
}

template <int DH, int G, typename T>
int launch_decode(const T* q, const T* k, const T* v, T* o,
                  float* part_m, float* part_l, float* part_acc, int B,
                  int KH, int L, int lo, int hi, int split, int nsplit,
                  float scale, cudaStream_t stream) {
  static_assert(decode_smem_bytes<DH, G>() <= 48 * 1024,
                "above 48 KB the launch would have to ask for it");
  const dim3 grid((unsigned)nsplit,
                  (unsigned)(KH * decode_head_groups<DH, G>()), (unsigned)B);
  decode_split_kernel<DH, G, T><<<grid, kThreads,
                                  decode_smem_bytes<DH, G>(), stream>>>(
      q, k, v, part_m, part_l, part_acc, L, KH, lo, hi, split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int CT = DH < 64 ? DH : 64;  // columns a combine block takes
  decode_combine_kernel<T><<<dim3((unsigned)(KH * G), (unsigned)B, DH / CT),
                             CT, 0, stream>>>(part_m, part_l, part_acc, o,
                                              KH * G, nsplit, DH);
  return (int)cudaGetLastError();
}

template <int N> struct HeadsPerKv { static constexpr int value = N; };

// Calls f(HeadsPerKv<G>{}) for a decode instantiation at DH -- G = H/KH in
// {1, 2, 3, 4, 6, 8}, at dh 128 also 5 (qwen2.5-32b) and 12 (starcoder2)
// -- and returns `bad` for any other G.  The launcher's GROUPS
// (kernels/decode_attention.py) mirrors the list.
template <int DH, typename F>
int with_decode_g(int G, int bad, F f) {
  switch (G) {
    case 1: return f(HeadsPerKv<1>{});
    case 2: return f(HeadsPerKv<2>{});
    case 3: return f(HeadsPerKv<3>{});
    case 4: return f(HeadsPerKv<4>{});
    case 5: if constexpr (DH == 128) return f(HeadsPerKv<5>{}); break;
    case 6: return f(HeadsPerKv<6>{});
    case 8: return f(HeadsPerKv<8>{});
    case 12: if constexpr (DH == 128) return f(HeadsPerKv<12>{}); break;
  }
  return bad;
}

template <int DH, typename T>
int launch_decode_g(int G, const T* q, const T* k, const T* v, T* o,
                    float* pm, float* pl, float* pa, int B, int KH, int L,
                    int lo, int hi, int split, int nsplit, float scale,
                    cudaStream_t st) {
  return with_decode_g<DH>(G, (int)cudaErrorInvalidValue, [&](auto g) {
    return launch_decode<DH, decltype(g)::value, T>(
        q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
  });
}

template <int DH, typename T>
int decode_residency_g(int G) {
  return with_decode_g<DH>(G, -(int)cudaErrorInvalidValue, [](auto g) {
    return decode_residency<DH, decltype(g)::value, T>();
  });
}

// Sizes att_flash and att_flash_wide refuse.  Skv != S is taken only
// non-causal without a window at dh 16-128 (the dh-256 kernels count keys
// by S).
bool flash_sizes_bad(int S, int Skv, int H, int KH, int dh, int causal,
                     int window, int B) {
  if (KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 || Skv <= 0)
    return true;
  return Skv != S && (causal || window > 0 || dh > 128);
}

template <typename T>
int flash_at(const T* q, const T* k, const T* v, T* o, int B, int S, int Skv,
             int H, int KH, int dh, int causal, int window, float scale,
             cudaStream_t stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (flash_sizes_bad(S, Skv, H, KH, dh, causal, window, B))
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_flash<16>(q, k, v, o, B, S, Skv, H, KH, causal, window, scale, stream);
    case 32: return launch_flash<32>(q, k, v, o, B, S, Skv, H, KH, causal, window, scale, stream);
    case 64: return launch_flash_tiled<64>(q, k, v, o, B, S, Skv, H, KH, causal, window, scale, stream);
    case 128: return launch_flash_tiled<128>(q, k, v, o, B, S, Skv, H, KH, causal, window, scale, stream);
    case 256: return launch_flash_narrow(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int flash_wide_at(const T* q, const T* k, const T* v, T* o, int B, int S,
                  int Skv, int H, int KH, int dh, int causal, int window,
                  float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (dh != kDH256 || flash_sizes_bad(S, Skv, H, KH, dh, causal, window, B))
    return (int)cudaErrorInvalidValue;
  return launch_flash_wide(q, k, v, o, B, S, H, KH, causal, window, scale,
                           stream);
}

template <typename T>
int decode_at(const T* q, const T* k, const T* v, T* o, float* part_m,
              float* part_l, float* part_acc, int B, int H, int KH, int L,
              int dh, int lo, int hi, int split, int nsplit, float scale,
              cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || lo < 0 || hi > L || lo >= hi || split <= 0 ||
      nsplit <= 0 || (long long)split * nsplit < hi - lo || B > 65535 ||
      KH > 32767)  // grid y holds KH x 2 head groups at dh 256 and G 12
    return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  switch (dh) {
    case 16: return launch_decode_g<16>(G, q, k, v, o, part_m, part_l, part_acc, B, KH, L, lo, hi, split, nsplit, scale, stream);
    case 32: return launch_decode_g<32>(G, q, k, v, o, part_m, part_l, part_acc, B, KH, L, lo, hi, split, nsplit, scale, stream);
    case 64: return launch_decode_g<64>(G, q, k, v, o, part_m, part_l, part_acc, B, KH, L, lo, hi, split, nsplit, scale, stream);
    case 128: return launch_decode_g<128>(G, q, k, v, o, part_m, part_l, part_acc, B, KH, L, lo, hi, split, nsplit, scale, stream);
    case 256:  // recurrentgemma-2b: 10 query heads over 1 kv head only
      if (G != 10) return (int)cudaErrorInvalidValue;
      return launch_decode<256, 10>(q, k, v, o, part_m, part_l, part_acc, B, KH, L, lo, hi, split, nsplit, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int decode_residency_at(int dh, int G) {
  switch (dh) {
    case 16: return decode_residency_g<16, T>(G);
    case 32: return decode_residency_g<32, T>(G);
    case 64: return decode_residency_g<64, T>(G);
    case 128: return decode_residency_g<128, T>(G);
    case 256:
      return G == 10 ? decode_residency<256, 10, T>()
                     : -(int)cudaErrorInvalidValue;
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) in the port's layouts; window <= 0 means none.
// Skv != S (cross attention) only non-causal without a window at dh 16-128.
// The _bf16 entries take bf16 q, k, v and o (module header).
int att_flash(const float* q, const float* k, const float* v, float* o, int B,
              int S, int Skv, int H, int KH, int dh, int causal, int window,
              float scale, cudaStream_t stream) {
  return flash_at(q, k, v, o, B, S, Skv, H, KH, dh, causal, window, scale,
                  stream);
}

int att_flash_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int S, int Skv, int H, int KH, int dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  return flash_at(q, k, v, o, B, S, Skv, H, KH, dh, causal, window, scale,
                  stream);
}

// att_flash at dh 256 through the wide kernel, for key spans of a whole
// 256-key tile or more (the launcher's rule:
// kernels/flash_attention.py::wide_tiles).
int att_flash_wide(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int Skv, int H, int KH, int dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  return flash_wide_at(q, k, v, o, B, S, Skv, H, KH, dh, causal, window,
                       scale, stream);
}

int att_flash_wide_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        int B, int S, int Skv, int H, int KH, int dh,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  return flash_wide_at(q, k, v, o, B, S, Skv, H, KH, dh, causal, window,
                       scale, stream);
}

// o[b,h] = attention of q[b,h] over cache positions [lo, hi), cut into
// nsplit splits of `split` positions; part_m / part_l hold B*H*nsplit
// floats and part_acc B*H*nsplit*dh (the caller's scratch, float32 for
// either element type).
int att_decode(const float* q, const float* k, const float* v, float* o,
               float* part_m, float* part_l, float* part_acc, int B, int H,
               int KH, int L, int dh, int lo, int hi, int split, int nsplit,
               float scale, cudaStream_t stream) {
  return decode_at(q, k, v, o, part_m, part_l, part_acc, B, H, KH, L, dh, lo,
                   hi, split, nsplit, scale, stream);
}

int att_decode_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                    float* part_m, float* part_l, float* part_acc, int B,
                    int H, int KH, int L, int dh, int lo, int hi, int split,
                    int nsplit, float scale, cudaStream_t stream) {
  return decode_at(q, k, v, o, part_m, part_l, part_acc, B, H, KH, L, dh, lo,
                   hi, split, nsplit, scale, stream);
}

// Blocks of att_decode's (att_decode_bf16's) split kernel for (dh, G =
// H/KH) that fit on one SM at its dynamic shared memory size;
// -cudaError_t on failure.
int att_decode_residency(int dh, int G) {
  return decode_residency_at<float>(dh, G);
}

int att_decode_residency_bf16(int dh, int G) {
  return decode_residency_at<bf16>(dh, G);
}

}  // extern "C"
