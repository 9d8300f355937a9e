// Shared C entry of the kernel library: text for the CUDA error codes that
// every other entry returns (ops/_build.py raises with it).
#include <cuda_runtime.h>

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
