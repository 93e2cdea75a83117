// Backward of the segmented softmax-attend (segment_softmax.cu). With the
// forward's residuals (the global per-(b, c) max gmax, the per-segment
// sums of exp(attn - gmax) and the output out), for each (b, n, c) whose
// segment s = idx[b, n] lies in [0, M):
//
//     w       = exp(attn - gmax[b, c]) / max(sums[b, s, c], 1e-30)
//     dvalues = w * g[b, s, c]
//     dattn   = w * g[b, s, c] * (values - out[b, s, c])
//
// and both are 0 for routed-out rows (they contributed nothing forward).
// The shift is the SAME global max the forward used, not a per-segment
// max: the closed form only needs w, and w is shift-invariant within a
// segment.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:_bwd (:145-176), the VJP of
// segment_softmax_attend_fused. On the TPU the closed form is plain XLA
// and its one Pallas call is the gather of the three [B, M, F] residual
// tables (sums, out, g) to the points through gather_rows_fused. Here the
// gather is fused into the closed form: one thread per (b, n, c) reads its
// segment's three table entries directly.
//
// Bound on the H100: memory. At 8 x 40960 x 64 -> 1280 the function must
// read attn and values (84 MB each), idx (1.3 MB), the three tables
// (3 x 2.6 MB, L2-resident) and gmax, and write dattn and dvalues (84 MB
// each). A warp covers 32 consecutive channels of one point, so
// every access is coalesced; no atomics, so the result is deterministic.

#include <math.h>

#include "common.cuh"

namespace {

__global__ void softmax_backward_kernel(
    const float* __restrict__ attn, const float* __restrict__ values,
    const int* __restrict__ idx, const float* __restrict__ out,
    const float* __restrict__ sums, const float* __restrict__ gmax,
    const float* __restrict__ g, float* __restrict__ dattn,
    float* __restrict__ dvalues, int N, int M, int F, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % F);
  const long long row = i / F;  // b * N + n
  const int b = (int)(row / N);
  const int s = idx[row];
  if (s < 0 || s >= M) {
    dattn[i] = 0.f;
    dvalues[i] = 0.f;
    return;
  }
  const size_t o = ((size_t)b * M + s) * F + c;
  const float w = expf(attn[i] - gmax[(size_t)b * F + c]) /
                  fmaxf(sums[o], 1e-30f);
  const float gw = w * g[o];
  dvalues[i] = gw;
  dattn[i] = gw * (values[i] - out[o]);
}

}  // namespace

// attn, values [B, N, F] f32; idx [B, N] int32; out, sums, g [B, M, F] f32;
// gmax [B, F] f32; dattn, dvalues [B, N, F] f32 (fully written). Returns a
// cudaError_t.
CMR_EXPORT int cmr_segment_softmax_backward(
    const float* attn, const float* values, const int* idx, const float* out,
    const float* sums, const float* gmax, const float* g, float* dattn,
    float* dvalues, int B, int N, int M, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long total = (long long)B * N * F;
  softmax_backward_kernel<<<cmr_blocks(total, threads), threads, 0, st>>>(
      attn, values, idx, out, sums, gmax, g, dattn, dvalues, N, M, F, total);
  CMR_RETURN_IF_ERROR();
  return 0;
}
