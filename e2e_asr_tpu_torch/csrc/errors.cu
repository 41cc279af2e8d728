// Error strings for the cudaError_t codes the C entry points return.
#include "common.cuh"

E2E_EXPORT const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
