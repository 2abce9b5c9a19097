// Attention kernels of the serving path for NVIDIA Hopper (sm_90a).
//
// Hand-written replacements of the two Pallas TPU attention kernels:
//
//   att_flash   q [B,S,H,dh], k,v [B,S,KH,dh] -> o [B,S,H,dh]
//               forward GQA attention with causal / sliding-window masks
//               (src/repro/kernels/flash_attention.py:71 flash_attention):
//               the prefill's attention (repro_torch/models/kv_cache.py).
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
//     over 64-key tiles staged in shared memory.  Key tiles wholly outside
//     the causal / window band are skipped -- the only skipped work, and it
//     does not change the result.  Ragged S: loads past S are zero-filled
//     and masked.  Causal tiles start heaviest first.  Two templates:
//     - dh 16, 32, 256 (flash_fwd_kernel): 256 threads; rows padded by one
//       float so scalar column reads are conflict-free.  Each thread owns 4
//       query rows x 4 keys of the score tile and 4 rows x dh/16 columns of
//       the accumulator; a row's max and sum reduce over the 16 lanes that
//       share it (butterfly shuffles: every lane gets the same bits).  Each
//       QK^T step makes 8 scalar shared loads for 16 FMAs, so the loop is
//       bound by shared-memory instruction throughput.
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
//       on 128 contiguous bytes), 12 loads for 128 FMAs at dh 64.  Scores
//       and PV sums are the same FMA chains in the same order as in the
//       other template; only the row sum l adds over 8 lanes, not 16.  q, k
//       and v are staged with 16-byte global loads, 8 in flight a tile per
//       thread before the stores, no per-element divides.  The grid is
//       (head, batch row, q tile), x fastest, so the heaviest causal tile
//       row of every head and batch row starts before any lighter one
//       (the other template orders tiles within a head and batch row only):
//       at B=4 S=2048 the last blocks to start are the lightest, not a
//       late head's 32-tile block.  ptxas (CUDA 12.8): 168 registers at dh
//       64, 167 at dh 128, no spills, so registers and shared memory alike
//       hold three dh-64 blocks (12 warps) on an SM.
//   * decode: the Pallas grid walks (b, query head) and reads each kv head
//     G = H/KH times; here a block serves the query heads of one kv head
//     (all G of them, or at dh 256 half of recurrentgemma-2b's ten: two
//     blocks of five fit an SM where one of ten did), so the cache is read
//     once, or twice through L2.  Grid: the valid range is cut into
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
// Instantiations: flash at dh 16, 32, 256 (flash_fwd_kernel) and 64, 128
// (flash_fwd_tiled_kernel), any H/KH; decode at dh 16-128 with G = H/KH in
// {1, 2, 3, 4, 6, 8}, and at dh 256 with G = 10 (recurrentgemma-2b's 10
// query heads over 1 kv head).  Flash shared memory: 214,016 bytes at dh
// 256 (one block per SM); 69,632 at dh 64 (three blocks per SM) and
// 118,784 at dh 128 (one) in the tiled template.  A decode block at dh 256
// keeps its five heads' q in shared memory (5 x 8 floats a lane would take
// 40 registers) beside a 41,280-byte merge buffer, 46,400 bytes in all.
// ptxas (CUDA 12.8): 128 registers at dh 256 / G 10 (__launch_bounds__
// asks for two blocks an SM) and 80 at dh 64 / G 3 (three), no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

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

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int causal, int window, float scale) {
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
  const float* qb = q + (size_t)b * S * q_stride + (size_t)h * DH;
  const float* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  float* ob = o + (size_t)b * S * q_stride + (size_t)h * DH;

  for (int i = threadIdx.x; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    sQ[r * LD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * q_stride + d] : 0.0f;
  }

  // keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
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
      const bool in = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * kv_stride + d;
      sK[r * LD + d] = in ? kb[off] : 0.0f;
      sV[r * LD + d] = in ? vb[off] : 0.0f;
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
        bool ok = kp < S;
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
      ob[(size_t)qp * q_stride + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int DH>
int launch_flash(const float* q, const float* k, const float* v, float* o,
                 int B, int S, int H, int KH, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<DH>();
  // above 48 KB, dynamic shared memory must be asked for (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, H, KH, causal, window, scale);
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
template <int DH, int NT>
__device__ __forceinline__ void stage_tiles(float* const (&dst)[NT],
                                            const float* const (&src)[NT],
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
                      ? __ldg(reinterpret_cast<const float4*>(
                            src[a] + (size_t)(p0 + r) * stride + c))
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

template <int DH>
__global__ void __launch_bounds__(kTileThreads)
flash_fwd_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int H, int KH, int causal, int window,
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
  const float* qb = q + (size_t)b * S * q_stride + (size_t)h * DH;
  const float* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * DH;
  float* ob = o + (size_t)b * S * q_stride + (size_t)h * DH;
  float* const kv_dst[2] = {sK, sV};
  const float* const kv_src[2] = {kb, vb};

  {
    float* const dst[1] = {sQ};
    const float* const src[1] = {qb};
    stage_tiles<DH, 1>(dst, src, q_stride, q0, S);
  }

  // keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
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
    stage_tiles<DH, 2>(kv_dst, kv_src, kv_stride, k0, S);
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
      *reinterpret_cast<float4*>(ob + (size_t)qp * q_stride +
                                 4 * (tx + 8 * c)) =
          make_float4(acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
                      acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
  }
}

template <int DH>
int launch_flash_tiled(const float* q, const float* k, const float* v,
                       float* o, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr int smem = flash_tiled_smem_bytes<DH>();
  // above 48 KB, dynamic shared memory must be asked for (per device); the
  // largest carveout is asked for so that three dh-64 blocks (3 x 69,632
  // bytes) fit an SM whatever carveout CUDA would pick by default
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tiled_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_tiled_kernel<DH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;  // grid z's limit
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
  flash_fwd_tiled_kernel<DH><<<grid, kTileThreads, smem, stream>>>(
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
// block an SM by registers; 5 heads let two run), else one.  The
// launcher's HEAD_GROUPS (kernels/decode_attention.py) mirrors it.
template <int DH>
__host__ __device__ constexpr int decode_head_groups() {
  return DH > 128 ? 2 : 1;
}

// q lives in shared memory when a block's GB = G / head groups heads'
// slices would take more than 32 registers a thread (dh 256); otherwise
// in registers.
template <int DH, int G>
__host__ __device__ constexpr bool decode_q_shared() {
  return G / decode_head_groups<DH>() * DecodeMap<DH>::VEC > 32;
}

// Blocks an SM the registers must allow: three (80 registers a thread)
// where a block's heads are few at dh <= 128 (flaas-100m's G = 3), two at
// dh 256 (128 registers), otherwise what ptxas needs.
template <int DH, int G>
__host__ __device__ constexpr int decode_min_blocks() {
  return DH > 128 ? 2 : G <= 3 ? 3 : 1;
}

// Dynamic shared memory of one decode block: q (when shared), then each
// lane group's (acc[GB][DH], m[GB], l[GB]) for the in-order merge; at
// most 46,400 bytes (dh 256), so no instantiation needs more than the
// 48 KB a launch gets without asking.
template <int DH, int G>
constexpr int decode_smem_bytes() {
  constexpr int GB = G / decode_head_groups<DH>();
  return ((decode_q_shared<DH, G>() ? GB * DH : 0) +
          DecodeMap<DH>::NGR * GB * (DH + 2)) * (int)sizeof(float);
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&dst)[VEC],
                                         const float* src) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src + e));
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
template <int DH, int G>
__global__ void __launch_bounds__(kThreads, decode_min_blocks<DH, G>())
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int L, int KH, int lo, int hi, int split, float scale) {
  using Map = DecodeMap<DH>;
  constexpr int VEC = Map::VEC, LG = Map::LG, NGR = Map::NGR, U = Map::U;
  constexpr int HG = decode_head_groups<DH>(), GB = G / HG;
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
  const float* qb = q + bh0 * DH;                               // GB rows

  float qreg[kQShared ? 1 : GB][VEC];
  if constexpr (kQShared) {
    for (int i = threadIdx.x; i < GB * DH; i += kThreads) sm_q[i] = qb[i];
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
  const float* kb = k + (size_t)b * L * row + (size_t)kvh * DH + li * VEC;
  const float* vb = v + (size_t)b * L * row + (size_t)kvh * DH + li * VEC;
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

__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      float* __restrict__ o, int H,
                                      int nsplit, int dh) {
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
    o[bh * dh + d] = aa / fmaxf(ll, 1e-20f);
  }
}

// Blocks of decode_split_kernel<DH, G> resident on one SM (registers,
// shared memory and threads), or -cudaError_t.
template <int DH, int G>
int decode_residency() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_split_kernel<DH, G>, kThreads, decode_smem_bytes<DH, G>());
  return err != cudaSuccess ? -(int)err : n;
}

template <int DH, int G>
int launch_decode(const float* q, const float* k, const float* v, float* o,
                  float* part_m, float* part_l, float* part_acc, int B,
                  int KH, int L, int lo, int hi, int split, int nsplit,
                  float scale, cudaStream_t stream) {
  static_assert(decode_smem_bytes<DH, G>() <= 48 * 1024,
                "above 48 KB the launch would have to ask for it");
  const dim3 grid((unsigned)nsplit,
                  (unsigned)(KH * decode_head_groups<DH>()), (unsigned)B);
  decode_split_kernel<DH, G><<<grid, kThreads, decode_smem_bytes<DH, G>(),
                               stream>>>(q, k, v, part_m, part_l, part_acc, L,
                                         KH, lo, hi, split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int CT = DH < 64 ? DH : 64;  // columns a combine block takes
  decode_combine_kernel<<<dim3((unsigned)(KH * G), (unsigned)B, DH / CT), CT,
                          0, stream>>>(part_m, part_l, part_acc, o, KH * G,
                                       nsplit, DH);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_decode_g(int G, const float* q, const float* k, const float* v,
                    float* o, float* pm, float* pl, float* pa, int B, int KH,
                    int L, int lo, int hi, int split, int nsplit, float scale,
                    cudaStream_t st) {
  switch (G) {
    case 1: return launch_decode<DH, 1>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    case 2: return launch_decode<DH, 2>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    case 3: return launch_decode<DH, 3>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    case 4: return launch_decode<DH, 4>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    case 6: return launch_decode<DH, 6>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    case 8: return launch_decode<DH, 8>(q, k, v, o, pm, pl, pa, B, KH, L, lo, hi, split, nsplit, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int DH>
int decode_residency_g(int G) {
  switch (G) {
    case 1: return decode_residency<DH, 1>();
    case 2: return decode_residency<DH, 2>();
    case 3: return decode_residency<DH, 3>();
    case 4: return decode_residency<DH, 4>();
    case 6: return decode_residency<DH, 6>();
    case 8: return decode_residency<DH, 8>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) in the port's layouts; window <= 0 means none.
int att_flash(const float* q, const float* k, const float* v, float* o, int B,
              int S, int H, int KH, int dh, int causal, int window,
              float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_flash<16>(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    case 32: return launch_flash<32>(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    case 64: return launch_flash_tiled<64>(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    case 128: return launch_flash_tiled<128>(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    case 256: return launch_flash<256>(q, k, v, o, B, S, H, KH, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// o[b,h] = attention of q[b,h] over cache positions [lo, hi), cut into
// nsplit splits of `split` positions; part_m / part_l hold B*H*nsplit
// floats and part_acc B*H*nsplit*dh (the caller's scratch).
int att_decode(const float* q, const float* k, const float* v, float* o,
               float* part_m, float* part_l, float* part_acc, int B, int H,
               int KH, int L, int dh, int lo, int hi, int split, int nsplit,
               float scale, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || lo < 0 || hi > L || lo >= hi || split <= 0 ||
      nsplit <= 0 || (long long)split * nsplit < hi - lo || B > 65535 ||
      KH > 32767)  // grid y holds KH x 2 head groups at dh 256
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

// Blocks of att_decode's split kernel for (dh, G = H/KH) that fit on one
// SM at its dynamic shared memory size; -cudaError_t on failure.
int att_decode_residency(int dh, int G) {
  switch (dh) {
    case 16: return decode_residency_g<16>(G);
    case 32: return decode_residency_g<32>(G);
    case 64: return decode_residency_g<64>(G);
    case 128: return decode_residency_g<128>(G);
    case 256:
      return G == 10 ? decode_residency<256, 10>()
                     : -(int)cudaErrorInvalidValue;
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
