// Error text for the codes the launchers return.
#include "common.cuh"

MAD_EXPORT const char* mad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
