// The opt-in to large dynamic shared memory, shared by correlation.cu,
// conv3x3.cu and stage1.cu. Above 48 KB a kernel has to be allowed its
// shared memory with cudaFuncSetAttribute, on each device it runs on.

#pragma once

#include <cuda_runtime.h>

namespace mfc {

// Allows `Kernel` the most dynamic shared memory a block of the current
// device may ask for beside the kernel's static shared memory, once per
// kernel and device, and gives that size in *limit. Returns 0 or the CUDA
// error.
template <auto Kernel>
int allow_shared_memory(int* limit) {
  constexpr int MAX_DEV = 64;
  static int allowed[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEV && allowed[dev]) {
    *limit = allowed[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;  // the kernel's static shared memory counts too
  err = cudaFuncGetAttributes(&fa, Kernel);
  if (err != cudaSuccess) return (int)err;
  *limit -= (int)fa.sharedSizeBytes;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEV) allowed[dev] = *limit;
  return 0;
}

}  // namespace mfc
