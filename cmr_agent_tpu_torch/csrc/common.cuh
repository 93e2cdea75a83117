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

static inline unsigned int cmr_blocks(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}
