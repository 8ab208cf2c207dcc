// Error strings for the ctypes wrappers: each entry point returns a
// cudaError_t as an int, and Python turns a non-zero one into a message.
#include <cuda_runtime.h>

extern "C" const char* ldp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
