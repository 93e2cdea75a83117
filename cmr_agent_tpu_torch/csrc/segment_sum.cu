// Batched segment sum: out[b, s, c] = sum over rows n with idx[b, n] == s
// of data[b, n, c]; rows whose idx lies outside [0, M) contribute nothing
// (the JAX package routes invalid rows out with idx >= M; -1 is handled
// the same way).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_sum_fused
// (_segment_sum_fused_impl, pallas_call at :240; a one-hot matmul per
// point tile on the TPU). On the training path it is the backward of the
// row gather (pallas_kernels.py:505-509): the node tables' gradients from
// the 40960 point rows (40960 -> 1280) and from the knn neighbourhoods
// (1280 x 16 -> 1280).
//
// Bound on the H100: memory. At 8 x 40960 x 64 -> 1280 the function must
// read the data (84 MB) and the ids (1.3 MB) and write the [8, 1280, 64]
// output (2.6 MB), which also stays in the 50 MB L2 while the atomics land
// in it. Design: one thread per (row, channel) with an f32 atomicAdd, so a
// warp reads 32 consecutive channels of one row (coalesced) and adds into
// 32 consecutive floats of one output row. The order of the atomics
// changes from run to run, so the f32 sums differ in their last bits.

#include "common.cuh"

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ data,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int M,
                                   int F, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % F);
  const long long row = i / F;  // b * N + n
  const int b = (int)(row / N);
  const int s = idx[row];
  if (s < 0 || s >= M) return;
  atomicAdd(&out[((size_t)b * M + s) * F + c], data[i]);
}

}  // namespace

// data [B, N, F] f32; idx [B, N] int32; out [B, M, F] f32 preset to 0.
// Returns a cudaError_t.
CMR_EXPORT int cmr_segment_sum(const float* data, const int* idx, float* out,
                               int B, int N, int M, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long total = (long long)B * N * F;
  segment_sum_kernel<<<cmr_blocks(total, threads), threads, 0, st>>>(
      data, idx, out, N, M, F, total);
  CMR_RETURN_IF_ERROR();
  return 0;
}
