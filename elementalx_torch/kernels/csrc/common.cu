// Helpers shared by the kernel wrappers.
#include <cuda_runtime.h>

extern "C" const char* elx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
