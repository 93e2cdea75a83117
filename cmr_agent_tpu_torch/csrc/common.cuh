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
// Operands read as given (f32 or bf16) and widened to f32 in registers,
// shared by the rasters (raster.cu) and the segment softmax
// (segment_softmax.cu). Widening bf16 is exact.
// ---------------------------------------------------------------------------

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of operands as floats.
__device__ __forceinline__ void unpack(const uint4 u, float (&o)[4], float) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4 u, float (&o)[8],
                                       __nv_bfloat16) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The raw 16 bytes at p (V operands from a 16-byte aligned address), or
// for V = 1 one operand's f32 bits, unpacked later by unpack_raw: a load
// in flight costs four registers whatever the dtype.
template <typename T, int V>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return make_uint4(__float_as_uint(to_f32(p[0])), 0u, 0u, 0u);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}
template <typename T, int V>
__device__ __forceinline__ void unpack_raw(const uint4 u, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = __uint_as_float(u.x);
  } else {
    unpack(u, o, T());
  }
}

}  // namespace
