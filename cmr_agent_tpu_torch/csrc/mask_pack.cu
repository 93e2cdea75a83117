// Stable mask compaction per sample: the rows n with mask[b, n] != 0 are
// packed first-index-first into feat_out[b, j, :] and pcT_out[b, :, j],
// j = 0, 1, ... < k; slots from min(count, k) on are written as zeros, and
// when more than k rows are masked the highest indices are dropped.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:mask_compact_pack
// (_mask_pack_kernel, pallas_call at :1510; on the TPU a triangular-matmul
// prefix count and a one-hot permutation matmul per point tile, with the
// running count carried through a sequential grid). It is the eval
// episode's one-off compaction under raster_mode "pack" and "mega".
//
// Bound on the H100: memory. At the episode's shape (mask [8, 40960], pcT
// [8, 3, 40960] f32, feat [8, 40960, 64] f32, k = 20480) the function reads
// the mask (0.3 MB) and the kept rows (at most 44 MB) and writes both
// outputs once (44 MB). Design, every output element written once, no
// zeroing pass, no atomics:
//  1. mask_rank_kernel, a cluster of 8 blocks per sample: the running
//     count of the TPU's sequential grid becomes a count per block, each
//     block's offset the sum of the counts before it, read once from the
//     cluster's shared memory, then a block-wide scan of 16 mask bytes a
//     thread (one 16-byte load where the rows are aligned). Each kept row
//     n of rank r < k lands in src[b, r] = n, listed in shared memory and
//     written in one coalesced sweep; kept[b] = min(count, k). A block
//     whose offset is past k ranks nothing. One block per sample took
//     14.8 us at the episode's shape; the cluster spreads it over 64 SMs.
//  2. mask_pack_kernel, a 256-thread block per 128 output slots: the
//     block reads its slots' source rows from src and copies them in
//     output order, the rows as bytes in 16-, 4- or 2-byte chunks,
//     neighbouring threads on neighbouring chunks (a 256-byte f32 row is
//     16 threads, a warp two rows) and four chunk loads in flight a
//     thread; a slot at or past kept[b] gets zeros. pcT is gathered as
//     f32. Every slot's row depends only on the mask, so the order is
//     first-index-first whichever block runs first, and any dtype packs
//     exactly.

#include <limits.h>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRankCluster = 8;  // rank blocks a sample, one cluster
constexpr int kRankThreads = 512;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankBytes = 16;   // mask bytes a thread per step
constexpr int kRankStep = kRankThreads * kRankBytes;
constexpr int kCopyThreads = 256;
constexpr int kSlots = 128;      // output slots a copy block
constexpr int kInFlight = 4;     // chunk loads in flight a thread

// Bit e set where row first + e (< end) is kept: one 16-byte load where
// the rows are aligned (`wide`: then [first, first + 16) is all in range
// or all out), else byte loads.
__device__ __forceinline__ unsigned int kept_bits(const uint8_t* m,
                                                  int first, int end,
                                                  bool wide) {
  unsigned int bits = 0;
  if (wide) {
    if (first < end) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(m + first));
      const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((w[i] >> (8 * e)) & 0xffu) bits |= 1u << (4 * i + e);
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRankBytes; ++e) {
      if (first + e < end && m[first + e] != 0) bits |= 1u << e;
    }
  }
  return bits;
}

// Exclusive prefix over the block of each thread's `mine`; `total` gets the
// block's sum. Starts and ends with the whole block in step.
__device__ __forceinline__ int block_scan(int mine, int* warp_off,
                                          int* total) {
  constexpr unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kRankWarps ? warp_off[lane] : 0;
    int w_incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(full, w_incl, d);
      if (lane >= d) w_incl += t;
    }
    if (lane < kRankWarps) warp_off[lane] = w_incl - v;
    if (lane == 31) *total = w_incl;
  }
  __syncthreads();
  const int out = warp_off[warp] + incl - mine;
  __syncthreads();  // warp_off is the next call's
  return out;
}

// A cluster of kRankCluster blocks a sample, block q taking the q-th
// eighth of the rows (a multiple of 16 long). Pass 1 counts each block's
// kept rows; a block's offset is the sum of the counts of the blocks before
// it, read from their shared memory. Pass 2 ranks the block's rows step by
// step, lists them in shared memory in row order and writes src[b, r] = n
// for ranks r < K in one coalesced sweep a step; block 0 writes kept[b] =
// min(count, K).
__global__ void __cluster_dims__(kRankCluster, 1, 1)
    __launch_bounds__(kRankThreads)
        mask_rank_kernel(const uint8_t* __restrict__ mask,
                         int* __restrict__ src, int* __restrict__ kept, int N,
                         int K, bool wide) {
  __shared__ int listed[kRankStep];
  __shared__ int warp_off[kRankWarps];
  __shared__ int step_total;
  __shared__ int block_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int per = (N + kRankCluster * kRankBytes - 1) /
                  (kRankCluster * kRankBytes) * kRankBytes;
  const int r0 = min(N, q * per), r1 = min(N, r0 + per);
  const uint8_t* m = mask + (size_t)b * N;

  int mine = 0;
  for (int j0 = r0; j0 < r1; j0 += kRankStep) {
    mine += __popc(kept_bits(m, j0 + threadIdx.x * kRankBytes, r1, wide));
  }
  block_scan(mine, warp_off, &block_count);
  cluster.sync();
  int offset = 0, count = 0;
  for (int p = 0; p < kRankCluster; ++p) {
    const int c = *cluster.map_shared_rank(&block_count, p);
    if (p < q) offset += c;
    count += c;
  }
  if (q == 0 && threadIdx.x == 0) kept[b] = min(count, K);
  cluster.sync();  // every block's count read before any block exits

  int* out = src + (size_t)b * K;
  for (int j0 = r0; j0 < r1 && offset < K; j0 += kRankStep) {
    const int first = j0 + threadIdx.x * kRankBytes;
    unsigned int bits = kept_bits(m, first, r1, wide);
    int at = block_scan(__popc(bits), warp_off, &step_total);
    while (bits != 0) {
      const int e = __ffs(bits) - 1;
      bits &= bits - 1;
      listed[at++] = first + e;
    }
    __syncthreads();
    const int n = min(step_total, K - offset);
    for (int i = threadIdx.x; i < n; i += kRankThreads) {
      out[offset + i] = listed[i];
    }
    offset += step_total;
    __syncthreads();  // listed is the next step's
  }
}

template <typename Chunk>
__global__ void __launch_bounds__(kCopyThreads)
    mask_pack_kernel(const float* __restrict__ pcT,
                     const Chunk* __restrict__ feat,
                     const int* __restrict__ src, const int* __restrict__ kept,
                     Chunk* __restrict__ feat_out, float* __restrict__ pcT_out,
                     int N, int K, int chunks_per_row) {
  __shared__ int rows_s[kSlots];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, K - s0);
  const int nk = kept[b];
  const int tid = threadIdx.x;
  for (int i = tid; i < ns; i += kCopyThreads) {
    rows_s[i] = s0 + i < nk ? src[(size_t)b * K + s0 + i] : -1;
  }
  __syncthreads();
  for (int i = tid; i < 3 * ns; i += kCopyThreads) {
    const int c = i / ns, s = i - c * ns;
    const int r = rows_s[s];
    pcT_out[((size_t)b * 3 + c) * K + s0 + s] =
        r >= 0 ? pcT[((size_t)b * 3 + c) * N + r] : 0.f;
  }
  // the block's ns rows of chunks_per_row chunks, in output order
  const int total = ns * chunks_per_row;
  const Chunk* from = feat + (size_t)b * N * chunks_per_row;
  Chunk* to = feat_out + ((size_t)b * K + s0) * chunks_per_row;
  for (int e0 = tid; e0 < total; e0 += kCopyThreads * kInFlight) {
    Chunk v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kCopyThreads;
      v[u] = Chunk{};
      if (e < total) {
        const int s = e / chunks_per_row;
        const int r = rows_s[s];
        if (r >= 0) {
          v[u] = from[(size_t)r * chunks_per_row + (e - s * chunks_per_row)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kCopyThreads;
      if (e < total) to[e] = v[u];
    }
  }
}

template <typename Chunk>
int launch(const uint8_t* mask, const float* pcT, const void* feat,
           int* src, int* kept, void* feat_out, float* pcT_out, int B, int N,
           int K, int row_bytes, cudaStream_t st) {
  const bool wide =
      N % kRankBytes == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  mask_rank_kernel<<<dim3(kRankCluster, B), kRankThreads, 0, st>>>(
      mask, src, kept, N, K, wide);
  CMR_RETURN_IF_ERROR();
  const dim3 grid((K + kSlots - 1) / kSlots, B);
  mask_pack_kernel<Chunk><<<grid, kCopyThreads, 0, st>>>(
      pcT, static_cast<const Chunk*>(feat), src, kept,
      static_cast<Chunk*>(feat_out), pcT_out, N, K,
      row_bytes / (int)sizeof(Chunk));
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// mask [B, N] bytes (non-zero = keep); pcT [B, 3, N] f32; feat [B, N,
// row_bytes]; scratch [B * K + B] int32 (the ranked rows, then the kept
// counts); feat_out [B, K, row_bytes] and pcT_out [B, 3, K], every element
// written. chunk_bytes is 16, 4 or 2 and divides row_bytes and both feature
// pointers' alignment (the wrapper checks). Returns a cudaError_t, or
// CMR_ERR_ARGUMENT for an unsupported chunk size, K < 1 or a row too wide.
CMR_EXPORT int cmr_mask_pack(const uint8_t* mask, const float* pcT,
                             const void* feat, int* scratch, void* feat_out,
                             float* pcT_out, int B, int N, int K,
                             int row_bytes, int chunk_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || N < 0 || row_bytes < 1 ||
      (long long)kSlots * row_bytes > INT_MAX) {
    return CMR_ERR_ARGUMENT;
  }
  if (B == 0) return 0;
  int* kept = scratch + (size_t)B * K;
  switch (chunk_bytes) {
    case 16:
      return launch<uint4>(mask, pcT, feat, scratch, kept, feat_out, pcT_out,
                           B, N, K, row_bytes, st);
    case 4:
      return launch<uint32_t>(mask, pcT, feat, scratch, kept, feat_out,
                              pcT_out, B, N, K, row_bytes, st);
    case 2:
      return launch<uint16_t>(mask, pcT, feat, scratch, kept, feat_out,
                              pcT_out, B, N, K, row_bytes, st);
    default:
      return CMR_ERR_ARGUMENT;
  }
}
