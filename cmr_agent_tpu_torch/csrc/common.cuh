// Shared helpers of the port's CUDA kernels.
//
// Every C entry point launches on the caller's stream, allocates nothing
// (the PyTorch wrapper owns outputs and scratch), never synchronises, and
// returns cudaGetLastError() after its launches so that a refused launch
// (bad configuration, too much shared memory) reaches the wrapper as an
// error code instead of silently not running.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define CMR_EXPORT extern "C" __attribute__((visibility("default")))

#define CMR_RETURN_IF_ERROR()                      \
  do {                                             \
    cudaError_t cmr_err_ = cudaGetLastError();     \
    if (cmr_err_ != cudaSuccess) return (int)cmr_err_; \
  } while (0)

// The kernels' own refusals, beside CUDA's (positive) error codes: -1 an
// unsupported argument, -2 operands that do not fit in a block's shared
// memory (ops/kernels.py:_REFUSALS names them).
#define CMR_ERR_ARGUMENT (-1)
#define CMR_ERR_SHARED_MEMORY (-2)

static inline unsigned int cmr_blocks(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// Pixel raster, shared by the pixel-id raster (raster_image.cu) and the
// compacting raster (raster_compact.cu); they differ only in where a row's
// pixel comes from and which rows a block visits. The accumulator is
// [B, h*w, F+1]: F feature sums, then the count.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
struct AccumOf {
  using type = float;
};
template <>
struct AccumOf<int8_t> {
  using type = int;
};

__device__ inline float to_accum(float v, float) { return v; }
__device__ inline float to_accum(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ inline int to_accum(int8_t v, int) { return (int)v; }

// Adds one feature row and a count of one into a pixel's accumulator row;
// lane `lane` of `lanes` takes channels lane, lane + lanes, ...
template <typename T, typename Acc>
__device__ inline void raster_accumulate_row(Acc* __restrict__ dst,
                                             const T* __restrict__ src, int F,
                                             int lane, int lanes) {
  for (int c = lane; c < F; c += lanes) {
    atomicAdd(&dst[c], to_accum(src[c], Acc(0)));
  }
  if (lane == 0) atomicAdd(&dst[F], Acc(1));
}

// One thread per (pixel, channel): means = sums (times the int8 scale, when
// given) / max(count, 1), or the scaled sums themselves when `divide` is
// false; counts written once per pixel.
template <typename Acc>
__global__ void raster_finalise_kernel(const Acc* __restrict__ acc,
                                       const float* __restrict__ scale,
                                       float* __restrict__ means,
                                       float* __restrict__ cnt_out, int HW,
                                       int F, long long total, bool divide) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % F);
  const long long bp = i / F;  // b * HW + p
  const int b = (int)(bp / HW);
  const Acc* row = acc + bp * (F + 1);
  const float cnt = (float)row[F];
  float s = (float)row[c];
  if (scale != nullptr) s = s * scale[(size_t)b * F + c];
  means[i] = divide ? s / fmaxf(cnt, 1.f) : s;
  if (c == 0) cnt_out[bp] = cnt;
}

template <typename Acc>
int raster_finalise(const Acc* acc, const float* scale, float* means,
                    float* cnt_out, int B, int HW, int F, cudaStream_t st,
                    bool divide = true) {
  const int threads = 256;
  const long long total = (long long)B * HW * F;
  raster_finalise_kernel<Acc><<<cmr_blocks(total, threads), threads, 0, st>>>(
      acc, scale, means, cnt_out, HW, F, total, divide);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace
