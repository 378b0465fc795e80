// The message of a CUDA error code, for the Python wrappers (ext.check):
// every kernel library exports it under the same name. And the grid of a
// grid-stride kernel, from its occupancy, for the libraries that size
// their own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// CTAs of ``threads`` threads and ``smem`` dynamic shared bytes: as many
// as fit the card at once, at most ``max_ctas`` and no more than ``work``
// threads' worth (one a row, a group or a lane of a chunk, as the kernel
// takes its work). ``*err`` holds the first failing runtime call's code.
template <class F>
int grid_ctas(F kernel, int threads, size_t smem, int64_t work,
              int64_t max_ctas, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
  int64_t ctas = (int64_t)sms * (per_sm < 1 ? 1 : per_sm);
  const int64_t blocks = (work + threads - 1) / threads;
  if (ctas > blocks) ctas = blocks;
  if (ctas > max_ctas) ctas = max_ctas;
  return ctas < 1 ? 1 : (int)ctas;
}
