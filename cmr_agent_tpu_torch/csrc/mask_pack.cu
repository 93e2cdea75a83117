// Stable mask compaction per sample: the rows n with mask[b, n] != 0 are
// packed first-index-first into feat_out[b, j, :] and pcT_out[b, :, j],
// j = 0, 1, ... < k. Rows past min(count, k) stay zero (the wrapper presets
// both outputs to 0); when more than k rows are masked the highest indices
// are dropped.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:mask_compact_pack
// (_mask_pack_kernel, pallas_call at :1510; on the TPU a triangular-matmul
// prefix count and a one-hot permutation matmul per point tile, with the
// running count carried through a sequential grid). It is the eval
// episode's one-off compaction under raster_mode "pack" and "mega".
//
// Bound on the H100: memory. At the episode's shape (mask [8, 40960], pcT
// [8, 3, 40960] f32, feat [8, 40960, 64] f32, k = 20480) the function reads
// the mask (0.3 MB) and the kept rows (at most 44 MB) and writes 44 MB.
// Design: Hopper blocks run in no order, so the running count becomes two
// small launches. The first counts the masked rows of each 256-row tile.
// In the second, every block sums the counts of the tiles before its own
// (at most 160 integers, from L2) for its offset, ranks its own rows with
// warp ballots, and copies each kept row to slot offset + rank when that is
// below k: the slot depends only on the mask, never on which block ran
// first, so the order is first-index-first by construction and no atomic
// assigns a slot. The feature rows are copied as bytes, a warp per row in
// 16-, 4- or 2-byte chunks, so any dtype is packed exactly; pcT is copied
// as f32.

#include "common.cuh"

namespace {

constexpr int kTile = 256;  // rows per block, one per thread

__global__ void mask_count_kernel(const uint8_t* __restrict__ mask,
                                  int* __restrict__ tile_counts, int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kTile + threadIdx.x;
  const int kept = n < N && mask[(size_t)b * N + n] != 0;
  const int total = __syncthreads_count(kept);
  if (threadIdx.x == 0) tile_counts[b * gridDim.x + blockIdx.x] = total;
}

template <typename Chunk>
__global__ void mask_pack_kernel(const uint8_t* __restrict__ mask,
                                 const float* __restrict__ pcT,
                                 const Chunk* __restrict__ feat,
                                 const int* __restrict__ tile_counts,
                                 Chunk* __restrict__ feat_out,
                                 float* __restrict__ pcT_out, int N, int K,
                                 int chunks_per_row) {
  __shared__ int warp_sums[kTile / 32];
  __shared__ int slots[kTile];
  __shared__ int block_offset;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned full = 0xffffffffu;

  // rows kept in the tiles before this one
  int part = 0;
  for (int t = tid; t < (int)blockIdx.x; t += kTile) {
    part += tile_counts[b * gridDim.x + t];
  }
  for (int d = 16; d > 0; d >>= 1) part += __shfl_down_sync(full, part, d);
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i < kTile / 32; ++i) total += warp_sums[i];
    block_offset = total;
  }
  __syncthreads();
  const int offset = block_offset;
  if (offset >= K) return;  // the whole tile overflows the budget

  // rank of each kept row within the tile
  const int n = blockIdx.x * kTile + tid;
  const bool kept = n < N && mask[(size_t)b * N + n] != 0;
  const unsigned ballot = __ballot_sync(full, kept);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_sums[i];
  const int dest = offset + before + __popc(ballot & ((1u << lane) - 1u));
  const int slot = (kept && dest < K) ? dest : -1;
  slots[tid] = slot;
  if (slot >= 0) {
    for (int c = 0; c < 3; ++c) {
      pcT_out[((size_t)b * 3 + c) * K + slot] =
          pcT[((size_t)b * 3 + c) * N + n];
    }
  }
  __syncthreads();

  // a warp per kept row: byte copy of the feature row
  for (int r = warp; r < kTile; r += kTile / 32) {
    const int s = slots[r];
    if (s < 0) continue;
    const Chunk* src =
        feat + ((size_t)b * N + blockIdx.x * kTile + r) * chunks_per_row;
    Chunk* dst = feat_out + ((size_t)b * K + s) * chunks_per_row;
    for (int ch = lane; ch < chunks_per_row; ch += 32) dst[ch] = src[ch];
  }
}

template <typename Chunk>
int launch(const uint8_t* mask, const float* pcT, const void* feat,
           int* tile_counts, void* feat_out, float* pcT_out, int B, int N,
           int K, int row_bytes, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, B);
  mask_count_kernel<<<grid, kTile, 0, st>>>(mask, tile_counts, N);
  CMR_RETURN_IF_ERROR();
  mask_pack_kernel<Chunk><<<grid, kTile, 0, st>>>(
      mask, pcT, static_cast<const Chunk*>(feat), tile_counts,
      static_cast<Chunk*>(feat_out), pcT_out, N, K,
      row_bytes / (int)sizeof(Chunk));
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// mask [B, N] bytes (non-zero = keep); pcT [B, 3, N] f32; feat [B, N,
// row_bytes]; tile_counts [B, ceil(N / 256)] int32 scratch; feat_out [B, K,
// row_bytes] and pcT_out [B, 3, K] preset to 0. chunk_bytes is 16, 4 or 2
// and divides row_bytes and both feature pointers' alignment (the wrapper
// checks). Returns a cudaError_t, or -1 for an unsupported chunk size.
CMR_EXPORT int cmr_mask_pack(const uint8_t* mask, const float* pcT,
                             const void* feat, int* tile_counts,
                             void* feat_out, float* pcT_out, int B, int N,
                             int K, int row_bytes, int chunk_bytes,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk_bytes) {
    case 16:
      return launch<uint4>(mask, pcT, feat, tile_counts, feat_out, pcT_out, B,
                           N, K, row_bytes, st);
    case 4:
      return launch<uint32_t>(mask, pcT, feat, tile_counts, feat_out, pcT_out,
                              B, N, K, row_bytes, st);
    case 2:
      return launch<uint16_t>(mask, pcT, feat, tile_counts, feat_out, pcT_out,
                              B, N, K, row_bytes, st);
    default:
      return -1;
  }
}
