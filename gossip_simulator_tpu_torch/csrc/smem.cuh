// smem.cuh: a launch's dynamic shared memory past the default allowance.

#pragma once

#include <cuda_runtime.h>

// Lets `kernel` take `bytes` of dynamic shared memory.  Without the
// attribute a kernel's dynamic allowance is 48 KB less its static shared
// memory, so the attribute is set on every launch that takes any: it
// belongs to the current device, and it is a cheap call beside a launch.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
