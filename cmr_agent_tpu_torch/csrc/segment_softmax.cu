// Segmented softmax-attend: out[b, s, c] = sum over points n with
// idx[b, n] == s of softmax_s(attn[b, :, c])[n] * values[b, n, c].
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_softmax_attend_fused
// (the GroupPointTransformer group softmax; one-hot matmuls on the TPU).
// Like the TPU kernel, the softmax is stabilised by the GLOBAL per-(b, c)
// max instead of the per-segment max: softmax is invariant to any shift
// constant within a segment, so the result is exact up to rounding.
//
// Bound on the H100: memory. At the main path's 40960 -> 1280 shape
// (B=8, F=64) the function must read attn and values (84 MB) and idx and
// write the [B, M, F] output; the segment sums live in a [B, M, F] f32
// scratch that stays in the 50 MB L2. Design: three simple passes.
//   1. per-(b, c) max over N: block-local reduction, then a float atomic max;
//   2. one thread per (point, channel): e = exp(a - max), atomicAdd of e and
//      e * v into the sums and the output (coalesced: a warp covers 32
//      consecutive channels of one point);
//   3. divide by max(sum, 1e-30) (empty segments stay 0).
// Points whose idx lies outside [0, M) contribute nothing. Atomics make the
// f32 sums order-dependent (rounding only). Sorted-segment or
// shared-memory designs are left to later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 512;

__device__ inline void atomic_max_float(float* addr, float v) {
  if (v == 0.f) v = 0.f;  // -0.0 -> +0.0 so the int ordering below holds
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// grid (ceil(F/32), B, ceil(N/kMaxRowsPerBlock)), block (32, 8)
__global__ void channel_max_kernel(const float* __restrict__ attn,
                                   float* __restrict__ gmax, int N, int F) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kMaxRowsPerBlock;
  const int r1 = min(N, r0 + kMaxRowsPerBlock);
  float m = -INFINITY;
  if (c < F) {
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      m = fmaxf(m, attn[((size_t)b * N + r) * F + c]);
    }
  }
  part[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && c < F) {
    for (int i = 1; i < blockDim.y; ++i) m = fmaxf(m, part[i][threadIdx.x]);
    atomic_max_float(&gmax[(size_t)b * F + c], m);
  }
}

__global__ void softmax_accumulate_kernel(
    const float* __restrict__ attn, const float* __restrict__ values,
    const int* __restrict__ idx, const float* __restrict__ gmax,
    float* __restrict__ sums, float* __restrict__ out, int N, int M, int F,
    long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % F);
  const long long row = i / F;  // b * N + n
  const int b = (int)(row / N);
  const int s = idx[row];
  if (s < 0 || s >= M) return;
  const float e = expf(attn[i] - gmax[(size_t)b * F + c]);
  const size_t o = ((size_t)b * M + s) * F + c;
  atomicAdd(&sums[o], e);
  atomicAdd(&out[o], e * values[i]);
}

__global__ void normalise_kernel(const float* __restrict__ sums,
                                 float* __restrict__ out, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = out[i] / fmaxf(sums[i], 1e-30f);
}

}  // namespace

// attn, values [B, N, F] f32; idx [B, N] int32; gmax [B, F] preset to
// -inf; sums, out [B, M, F] preset to 0. Returns a cudaError_t.
CMR_EXPORT int cmr_segment_softmax_attend(const float* attn,
                                          const float* values, const int* idx,
                                          float* gmax, float* sums, float* out,
                                          int B, int N, int M, int F,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 mblock(32, 8);
  dim3 mgrid((F + 31) / 32, B, (N + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock);
  channel_max_kernel<<<mgrid, mblock, 0, st>>>(attn, gmax, N, F);
  CMR_RETURN_IF_ERROR();

  const int threads = 256;
  const long long total_in = (long long)B * N * F;
  softmax_accumulate_kernel<<<cmr_blocks(total_in, threads), threads, 0, st>>>(
      attn, values, idx, gmax, sums, out, N, M, F, total_in);
  CMR_RETURN_IF_ERROR();

  const long long total_out = (long long)B * M * F;
  normalise_kernel<<<cmr_blocks(total_out, threads), threads, 0, st>>>(
      sums, out, total_out);
  CMR_RETURN_IF_ERROR();
  return 0;
}
