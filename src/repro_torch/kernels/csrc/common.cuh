// Shared by every kernel source: the plain C interface the Python side
// loads with ctypes (repro_torch/device.py). Each entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported at once.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// torch.finfo(torch.float32).min: the score of every non-admitted doc
constexpr float kNeg = -FLT_MAX;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB (the attribute is per function; setting it again is free).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
