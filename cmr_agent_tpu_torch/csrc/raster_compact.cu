// Compacting pixel-id raster, sums + counts: for each sample b and row j
// with pixel id p = ids[b, j] in [0, h*w), the feature row data[b, j, :]
// and a count of one are summed into pixel p; a second pass writes the
// sums (times the int8 scale) and the counts. Rows arrive in any order
// (the whole, uncompacted cloud) and none is dropped.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:
// segment_sum_count_image_compact (_sum_image_compact_kernel, pallas_call
// at :846): the eval episode's raster under raster_mode "compact". The TPU
// kernel packs each 512-row tile's valid rows to the front with a prefix
// rank (a triangle matmul) and a permutation matmul in VMEM, then one-hot
// accumulates chunk by chunk up to the tile's valid count. Here the same
// per-tile packing is what a block does before its atomics: one block of
// 512 threads per (sample, tile), each thread reads one id, warp ballots
// and popcount prefixes give each valid row its rank, and the tile's valid
// (row, pixel) pairs land packed in shared memory; a tile without a valid
// id returns after that one read. Each warp then takes packed rows w, w +
// 16, ... and its lanes add the row's channels and the count into the
// [B, h*w, F+1] accumulator (shared with the other rasters, common.cuh).
//
// Operand modes: f32; bf16 read as bf16 and summed in f32; int8 quantised
// by the wrapper with one absmax scale per (sample, channel) over all N
// rows and summed in exact int32. The TPU kernel's int8 mode casts the
// features without quantising (:829-830), which truncates every |x| < 1 to
// 0; the port quantises as the flat raster does, so that the "compact"
// and "flat" rasters agree in every dtype.
//
// Bound on the H100: memory. At the eval episode's shape (B=8, N=40960,
// F=64, h*w=40*128) the function must read every id (1.3 MB) and the
// valid rows' features, and write the sums and counts (10.6 MB); the
// accumulator (10.8 MB) stays in the 50 MB L2.

#include "common.cuh"

namespace {

constexpr int kTileRows = 512;  // rows per block, one per thread
constexpr int kWarps = kTileRows / 32;

template <typename T>
__global__ void __launch_bounds__(kTileRows)
    raster_compact_kernel(const T* __restrict__ feat,
                          const int* __restrict__ ids,
                          typename AccumOf<T>::type* __restrict__ acc, int N,
                          int F, int HW) {
  __shared__ int rows_s[kTileRows];
  __shared__ int pix_s[kTileRows];
  __shared__ int warp_offset[kWarps];
  __shared__ int n_valid;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = blockIdx.x * kTileRows + tid;
  const int pix = j < N ? ids[(size_t)b * N + j] : HW;
  const bool valid = pix >= 0 && pix < HW;
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) warp_offset[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the warps' counts
    const int own = lane < kWarps ? warp_offset[lane] : 0;
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane < kWarps) warp_offset[lane] = incl - own;
    if (lane == kWarps - 1) n_valid = incl;
  }
  __syncthreads();
  const int count = n_valid;
  if (count == 0) return;  // the whole block sees the same count
  if (valid) {
    const int rank = warp_offset[warp] + __popc(ballot & ((1u << lane) - 1u));
    rows_s[rank] = j;
    pix_s[rank] = pix;
  }
  __syncthreads();
  for (int p = warp; p < count; p += kWarps) {
    raster_accumulate_row(acc + ((size_t)b * HW + pix_s[p]) * (F + 1),
                          feat + ((size_t)b * N + rows_s[p]) * F, F, lane,
                          32);
  }
}

template <typename T>
int launch(const void* feat, const int* ids, const float* scale, void* acc,
           float* sums, float* cnt_out, int B, int N, int F, int HW,
           cudaStream_t st) {
  using Acc = typename AccumOf<T>::type;
  dim3 grid((N + kTileRows - 1) / kTileRows, B);
  raster_compact_kernel<T><<<grid, kTileRows, 0, st>>>(
      static_cast<const T*>(feat), ids, static_cast<Acc*>(acc), N, F, HW);
  CMR_RETURN_IF_ERROR();
  return raster_finalise(static_cast<const Acc*>(acc), scale, sums, cnt_out,
                         B, HW, F, st, /*divide=*/false);
}

}  // namespace

// feat [B, N, F] of kind 0 = f32, 1 = bf16, 2 = int8; ids [B, N] int32 (any
// id outside [0, HW) routed out); scale [B, F] f32 (int8 only, else null);
// acc [B, HW, F+1] zeroed, f32 (kinds 0, 1) or int32 (kind 2); sums
// [B, HW, F] and cnt_out [B, HW] f32. Returns a cudaError_t, or -1 for an
// unknown kind.
CMR_EXPORT int cmr_raster_compact(const void* feat, int feat_kind,
                                  const int* ids, const float* scale,
                                  void* acc, float* sums, float* cnt_out,
                                  int B, int N, int F, int HW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch<float>(feat, ids, nullptr, acc, sums, cnt_out, B, N, F,
                           HW, st);
    case 1:
      return launch<__nv_bfloat16>(feat, ids, nullptr, acc, sums, cnt_out, B,
                                   N, F, HW, st);
    case 2:
      return launch<int8_t>(feat, ids, scale, acc, sums, cnt_out, B, N, F, HW,
                            st);
    default:
      return -1;
  }
}
