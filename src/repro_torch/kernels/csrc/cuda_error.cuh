// The message of a CUDA error code, for the Python wrappers (ext.check):
// every kernel library exports it under the same name.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
