// Pixel-id raster mean + count: for each sample b and row j with pixel id
// p = ids[b, j] in [0, h*w), the feature row data[b, j, :] and a count of
// one are summed into pixel p; a second pass turns the sums into per-pixel
// means (0 where no row lands) and counts. Ids outside [0, h*w) (the
// caller routes invalid rows to h*w) contribute nothing.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_sum_image_fused on
// its flat path (_sum_image_flat_kernel, pallas_call at :670, reached
// through segment_mean_count_image_fused with factored=False and the
// in-kernel ones column): the observation raster of every training
// episode step. The TPU kernel builds a [T, h*w] one-hot per point tile
// and skips whole tiles whose ids are all routed out (a scalar-prefetched
// flag). Here the count is accumulated in the kernel as that ones column
// is, and the dead-tile gate becomes an early exit: each warp reads its
// row's id once and returns if the row is routed out, so the dead tail of
// a valid-first (top-K compacted) layout costs one id read per row.
//
// Operand modes: f32, and bf16 read as bf16 and summed in f32 (one
// rounding of the inputs, exact products), as the TPU kernel's bf16
// one-hot matmul with f32 accumulation. The int8 mode of the TPU kernel
// is not ported (no training episode uses it).
//
// Bound on the H100: memory. At the training path's shape (B=8, K=20480,
// F=64, h*w=40*128) the function must read every id (0.66 MB) and the
// feature rows that land in the frame (at most 42 MB in f32), and write
// means and counts (10.6 MB); the [B, h*w, F+1] accumulator (10.8 MB)
// stays in the 50 MB L2. Design: the projection-fused raster's (raster.cu)
// block of 8 rows x 32 channel lanes and its shared accumulate/finalise
// device code (common.cuh); only the source of the pixel id differs.

#include "common.cuh"

namespace {

template <typename T>
__global__ void raster_image_kernel(const T* __restrict__ feat,
                                    const int* __restrict__ ids,
                                    float* __restrict__ acc, int K, int F,
                                    int HW) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= K) return;
  const int pix = ids[(size_t)b * K + j];
  if (pix < 0 || pix >= HW) return;  // routed out
  raster_accumulate_row(acc + ((size_t)b * HW + pix) * (F + 1),
                        feat + ((size_t)b * K + j) * F, F, threadIdx.x,
                        blockDim.x);
}

template <typename T>
int launch(const void* feat, const int* ids, float* acc, float* means,
           float* cnt_out, int B, int K, int F, int HW, cudaStream_t st) {
  dim3 block(32, 8);
  dim3 grid((K + 7) / 8, B);
  raster_image_kernel<T><<<grid, block, 0, st>>>(static_cast<const T*>(feat),
                                                 ids, acc, K, F, HW);
  CMR_RETURN_IF_ERROR();
  return raster_finalise<float>(acc, nullptr, means, cnt_out, B, HW, F, st);
}

}  // namespace

// feat [B, K, F] of kind 0 = f32, 1 = bf16; ids [B, K] int32; acc
// [B, HW, F+1] f32 zeroed; means [B, HW, F] and cnt_out [B, HW] f32.
// Returns a cudaError_t, or -1 for an unknown kind.
CMR_EXPORT int cmr_raster_image(const void* feat, int feat_kind,
                                const int* ids, float* acc, float* means,
                                float* cnt_out, int B, int K, int F, int HW,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch<float>(feat, ids, acc, means, cnt_out, B, K, F, HW, st);
    case 1:
      return launch<__nv_bfloat16>(feat, ids, acc, means, cnt_out, B, K, F,
                                   HW, st);
    default:
      return -1;
  }
}
