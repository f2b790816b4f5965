// Helpers shared by every kernel library in csrc/.
//
// Each csrc/<name>.cu is built into its own shared library and loaded with
// ctypes; ops/_build.py reads av_error_string from each of them.

#pragma once

#include <cuda_runtime.h>

// BORDER_REFLECT_101 for any offset, through the period-2(n-1) reflection,
// so that frames narrower than the kernel stay right.
__device__ __forceinline__ int reflect101(int p, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = p % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

extern "C" const char* av_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
