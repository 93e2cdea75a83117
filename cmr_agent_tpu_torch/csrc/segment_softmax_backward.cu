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
// segment's three table entries directly (two channels a thread in bf16).
//
// attn and values are read as given, f32 or bf16 (both of one dtype), and
// widened in registers, as the forward reads them; the residuals and g are
// f32. dattn and dvalues come out in the operands' dtype: in bf16 each is
// the f32 result rounded once (round to nearest even). So a bf16 call is
// the f32 call on the widened operands with its outputs rounded, the exact
// derivative of the forward the port computes. The JAX _bwd instead
// subtracts and exponentiates in the operands' dtype and hands back f32
// cotangents (ROADMAP, "Known places where the reference diverges").
//
// Bound on the H100: memory. At 8 x 40960 x 64 -> 1280 the function must
// read attn and values (84 MB each in f32, 42 MB in bf16), idx (1.3 MB),
// the three tables (3 x 2.6 MB, L2-resident) and gmax, and write dattn and
// dvalues (84 MB each in f32, 42 MB in bf16). A warp covers 32 (bf16: 64)
// consecutive channels of one point, so every access is coalesced; no
// atomics and no sums across threads, so the result is the same bits on
// every launch.

#include <math.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive channels of one point per thread (V = 2 only for bf16 with
// an even F and 4-byte aligned operands, so a pair never straddles two
// points and moves as one 4-byte word).
template <typename T, int V>
__global__ void softmax_backward_kernel(
    const T* __restrict__ attn, const T* __restrict__ values,
    const int* __restrict__ idx, const float* __restrict__ out,
    const float* __restrict__ sums, const float* __restrict__ gmax,
    const float* __restrict__ g, T* __restrict__ dattn,
    T* __restrict__ dvalues, int N, int M, int F, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t * V;  // first element of this thread
  if (i >= total) return;
  const int c0 = (int)(i % F);
  const long long row = i / F;  // b * N + n
  const int b = (int)(row / N);
  const int s = idx[row];
  float a[V], v[V];
  if constexpr (V == 2) {
    const __nv_bfloat162 a2 =
        *reinterpret_cast<const __nv_bfloat162*>(attn + i);
    const __nv_bfloat162 v2 =
        *reinterpret_cast<const __nv_bfloat162*>(values + i);
    a[0] = __low2float(a2);
    a[1] = __high2float(a2);
    v[0] = __low2float(v2);
    v[1] = __high2float(v2);
  } else {
    a[0] = to_f32(attn[i]);
    v[0] = to_f32(values[i]);
  }
  float da[V], dv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (s < 0 || s >= M) {
      da[k] = 0.f;
      dv[k] = 0.f;
      continue;
    }
    const int c = c0 + k;
    const size_t o = ((size_t)b * M + s) * F + c;
    const float w =
        expf(a[k] - gmax[(size_t)b * F + c]) / fmaxf(sums[o], 1e-30f);
    const float gw = w * g[o];
    dv[k] = gw;
    da[k] = gw * (v[k] - out[o]);
  }
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dattn + i) =
        __floats2bfloat162_rn(da[0], da[1]);
    *reinterpret_cast<__nv_bfloat162*>(dvalues + i) =
        __floats2bfloat162_rn(dv[0], dv[1]);
  } else {
    store(dattn + i, da[0]);
    store(dvalues + i, dv[0]);
  }
}

template <typename T, int V>
int run(const void* attn, const void* values, const int* idx,
        const float* out, const float* sums, const float* gmax,
        const float* g, void* dattn, void* dvalues, int B, int N, int M,
        int F, cudaStream_t st) {
  const int threads = 256;
  const long long total = (long long)B * N * F;
  softmax_backward_kernel<T, V>
      <<<cmr_blocks(total / V, threads), threads, 0, st>>>(
          static_cast<const T*>(attn), static_cast<const T*>(values), idx,
          out, sums, gmax, g, static_cast<T*>(dattn),
          static_cast<T*>(dvalues), N, M, F, total);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// attn, values [B, N, F] of kind 0 = f32, 1 = bf16; idx [B, N] int32; out,
// sums, g [B, M, F] f32; gmax [B, F] f32; dattn, dvalues [B, N, F] of the
// operands' kind (fully written). Returns a cudaError_t, or before any
// launch -1 for an unsupported kind.
CMR_EXPORT int cmr_segment_softmax_backward(
    const void* attn, const void* values, int kind, const int* idx,
    const float* out, const float* sums, const float* gmax, const float* g,
    void* dattn, void* dvalues, int B, int N, int M, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 1) return CMR_ERR_ARGUMENT;
  if ((long long)B * N * F == 0) return 0;
  if (kind == 0) {
    return run<float, 1>(attn, values, idx, out, sums, gmax, g, dattn,
                         dvalues, B, N, M, F, st);
  }
  const uintptr_t ptrs = (uintptr_t)attn | (uintptr_t)values |
                         (uintptr_t)dattn | (uintptr_t)dvalues;
  if (F % 2 == 0 && ptrs % 4 == 0) {
    return run<__nv_bfloat16, 2>(attn, values, idx, out, sums, gmax, g,
                                 dattn, dvalues, B, N, M, F, st);
  }
  return run<__nv_bfloat16, 1>(attn, values, idx, out, sums, gmax, g, dattn,
                               dvalues, B, N, M, F, st);
}
