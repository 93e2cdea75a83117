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
// reads 2 MB of data and 64 MB of ids and writes a 2.63 GB output, far
// beyond the 50 MB L2. Design: a block per hypothesis (b, p), which
//   1. reads the hypothesis's N ids once and buckets its rows by pixel,
//      stably, in shared memory (bucket.cuh: offsets (M + 1) ints, 16-bit
//      ids, placement list and sorted rows, 69 KB at this shape, so three
//      blocks fit on an SM and one block's bucketing overlaps the others'
//      stores);
//   2. sweeps its contiguous [M, F] output slab in flat element order:
//      thread t takes 4 consecutive elements e = pixel * F + c at a time
//      (at most two pixels when F >= 4, their rows walked in lockstep),
//      adds data[b, row, c] over the pixel's rows in ascending row order
//      (the sample's table, 2.2 MB, is shared by its P hypotheses and read
//      from L2) and stores the 4 sums as one 16-byte vector with a
//      streaming store (the slab is 16-byte aligned when M * F is a
//      multiple of 4; rows of 264 bytes are not, which is why the sweep is
//      over the flat slab; otherwise, or for F < 4, one element at a
//      time).
// Every output byte crosses device memory once, the ids are read once, no
// zeroing pass and no global atomic: the bits are the same on every run. A
// hypothesis with every row routed out reads no row and writes zeros.
// Takes N <= 65536 and M <= 65535 (16-bit ids and rows), M * F < 2^31, and
// refuses a hypothesis whose buckets do not fit in a block's shared memory.

#include "bucket.cuh"

namespace {

constexpr int kThreads = 512;

constexpr int kSmemLimit = 232448;  // a block's opt-in shared memory

size_t shared_smem_bytes(int N, int M) {
  return (size_t)(M + 1 + 32) * sizeof(int) + 3 * (size_t)N * sizeof(uint16_t);
}

// The sum of element (q, c) of the slab: data rows of pixel q, in order.
__device__ inline float pixel_channel_sum(const float* __restrict__ table,
                                          const uint16_t* sorted,
                                          const int* off, int q, int c,
                                          int F) {
  float s = 0.f;
#pragma unroll 4
  for (int j = off[q], end = off[q + 1]; j < end; ++j) {
    s += __ldg(&table[(size_t)sorted[j] * F + c]);
  }
  return s;
}

// The 4 sums of elements (q, c) .. (q, c + 3) of the slab, F >= 4: the
// first `split` lie in pixel q, the rest in pixel q + 1 from channel 0. The
// two pixels' rows are walked in lockstep, so the up to 4 loads of a step
// are in flight together; each element still adds its rows in order.
__device__ inline float4 four_sums(const float* __restrict__ table,
                                   const uint16_t* sorted, const int* off,
                                   int q, int c, int F) {
  const int split = min(4, F - c);
  const int lo0 = off[q], n0 = off[q + 1] - lo0;
  const int lo1 = off[q + 1], n1 = split < 4 ? off[q + 2] - lo1 : 0;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  const int steps = max(n0, n1);
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    const int r0 = t < n0 ? sorted[lo0 + t] : -1;
    const int r1 = t < n1 ? sorted[lo1 + t] : -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = k < split ? r0 : r1;
      const int ch = k < split ? c + k : c + k - F;
      if (r >= 0) v[k] += __ldg(&table[(size_t)r * F + ch]);
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads, 3)
segment_sum_shared_kernel(const float* __restrict__ data,
                          const int* __restrict__ idx,
                          float* __restrict__ out, int P, int N, int M,
                          int F) {
  extern __shared__ int smem[];
  int* off = smem;                                        // M + 1
  int* scratch = off + M + 1;                             // 32
  uint16_t* bucket = reinterpret_cast<uint16_t*>(scratch + 32);  // N
  uint16_t* list = bucket + N;                            // N
  uint16_t* sorted = list + N;                            // N
  const long long map = blockIdx.x;                       // b * P + p
  const int b = (int)(map / P);
  const int tid = threadIdx.x;
  const int* ids = idx + map * N;
  for (int i = tid; i < N; i += kThreads) {
    const int s = ids[i];
    bucket[i] = (s >= 0 && s < M) ? (uint16_t)s : kRoutedOut;
  }
  __syncthreads();
  stable_bucket(bucket, N, M, off, list, sorted, scratch);
  __syncthreads();

  const float* table = data + (long long)b * N * F;
  const int total = M * F;
  float* slab = out + map * total;
  const bool dead = off[M] == 0;
  if ((total & 3) == 0 && F >= 4) {
    float4* slab4 = reinterpret_cast<float4*>(slab);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dead) {
      for (int e4 = tid; e4 < total / 4; e4 += kThreads) {
        __stcs(&slab4[e4], zero);
      }
      return;
    }
    // element e = 4 * e4 is (q, c) = (e / F, e % F); the next iteration's
    // is 4 * kThreads elements on
    const int step_q = 4 * kThreads / F, step_c = 4 * kThreads % F;
    int q = 4 * tid / F, c = 4 * tid % F;
    for (int e4 = tid; e4 < total / 4; e4 += kThreads) {
      __stcs(&slab4[e4], four_sums(table, sorted, off, q, c, F));
      q += step_q;
      c += step_c;
      if (c >= F) {
        c -= F;
        ++q;
      }
    }
  } else {
    for (int e = tid; e < total; e += kThreads) {
      slab[e] = dead ? 0.f
                     : pixel_channel_sum(table, sorted, off, e / F, e % F, F);
    }
  }
}

}  // namespace

// data [B, N, F] f32; idx [B, P, N] int32; out [B, P, M, F] f32, every
// element written here. Returns a cudaError_t, -1 for an unsupported size
// (N > 65536, M > 65535, M * F >= 2^31, more than 2^31 - 1 hypotheses) and
// -2 when a hypothesis's buckets exceed a block's shared memory.
CMR_EXPORT int cmr_segment_sum_shared(const float* data, const int* idx,
                                      float* out, int B, int P, int N, int M,
                                      int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long maps = (long long)B * P;
  if (N > 65536 || M > kMaxBucketSegments ||
      (long long)M * F > 2147483647LL || maps > 2147483647LL) {
    return CMR_ERR_ARGUMENT;
  }
  if (maps == 0 || M == 0 || F == 0) return 0;
  const size_t smem = shared_smem_bytes(N, M);
  if (smem > kSmemLimit) return CMR_ERR_SHARED_MEMORY;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  segment_sum_shared_kernel<<<(unsigned int)maps, kThreads, smem, st>>>(
      data, idx, out, P, N, M, F);
  CMR_RETURN_IF_ERROR();
  return 0;
}
