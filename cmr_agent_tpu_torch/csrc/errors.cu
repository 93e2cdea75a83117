// Error strings for the codes the other entry points return.

#include "common.cuh"

CMR_EXPORT const char* cmr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
