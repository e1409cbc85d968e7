// Error text for the status codes the kernel entry points return.
#include "common.cuh"

RT_API const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
