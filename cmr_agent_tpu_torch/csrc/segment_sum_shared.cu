// Shared-data segment sum: one table of rows data[b, n, :] summed under P
// index maps, out[b, p, s, c] = sum over rows n with idx[b, p, n] == s of
// data[b, n, c]; a row whose idx lies outside [0, M) contributes nothing to
// that hypothesis (the cost volume routes a point outside the frame out
// with idx = M).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_sum_fused_shared
// (_shared_sum_kernel, pallas_call at :365; on the TPU a one-hot matmul per
// (b, p, point tile) on a sequential grid, with a prefetched flag that
// skips tiles without an in-range row). It carries the cost volume's warp:
// the top-K compacted cloud's [features | score | 1] rows rastered under
// every pose hypothesis of an eval chunk.
//
// Bound on the H100: memory, and the output alone. At the cost volume's
// shape (data [8, 8192, 66], idx [8, 243, 8192], M = 5120) the function
// reads 2 MB of data and 64 MB of ids and writes a 2.63 GB output, which is
// far beyond the 50 MB L2. Design: the wrapper zeroes the output, then one
// warp per (b, p, row): the lanes read the row's id once (a broadcast),
// leave at once if it is routed out, and otherwise add the row's F
// channels, lane by lane, into out[b, p, id, :] with f32 atomics (coalesced
// reads of data, which stays in L2, and 32 consecutive atomics per warp
// step). Blocks are numbered so that neighbouring blocks work on the same
// (b, p): the 1.35 MB slice they add into is L2-resident while they run,
// and device memory sees each output element written about once after the
// zeroing. A block per (b, p, pixel tile) summing in shared memory would
// save the zeroing pass, but every such block must scan all N ids of its
// hypothesis and a 227 KB tile holds 860 of the 5120 pixels, six scans per
// hypothesis; the atomic form is the simpler one that is right. All offsets
// are 64-bit: B * P * M * F exceeds 2^31 at these shapes. The order of the
// atomics changes from run to run, so the f32 sums differ in their last
// bits.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;

__global__ void segment_sum_shared_kernel(const float* __restrict__ data,
                                          const int* __restrict__ idx,
                                          float* __restrict__ out, int P,
                                          int N, int M, int F,
                                          int chunks_per_map) {
  const long long map = blockIdx.x / chunks_per_map;  // b * P + p
  const int chunk = (int)(blockIdx.x % chunks_per_map);
  const int b = (int)(map / P);
  const int lane = threadIdx.x;
  const int* ids = idx + map * N;
  const float* rows = data + (long long)b * N * F;
  float* dst = out + map * M * F;
  const int first = chunk * kRowsPerBlock + threadIdx.y * kRowsPerWarp;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = first + r;
    if (n >= N) return;
    const int s = ids[n];
    if (s < 0 || s >= M) continue;
    const float* src = rows + (long long)n * F;
    float* seg = dst + (long long)s * F;
    for (int c = lane; c < F; c += 32) atomicAdd(&seg[c], src[c]);
  }
}

}  // namespace

// data [B, N, F] f32; idx [B, P, N] int32; out [B, P, M, F] f32 preset to 0.
// Returns a cudaError_t, or -1 when the grid would not fit.
CMR_EXPORT int cmr_segment_sum_shared(const float* data, const int* idx,
                                      float* out, int B, int P, int N, int M,
                                      int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks_per_map = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)B * P * chunks_per_map;
  if (blocks > 2147483647LL) return -1;
  segment_sum_shared_kernel<<<(unsigned int)blocks,
                              dim3(32, kWarpsPerBlock), 0, st>>>(
      data, idx, out, P, N, M, F, chunks_per_map);
  CMR_RETURN_IF_ERROR();
  return 0;
}
