// Raising a kernel's dynamic shared-memory limit, for the attention
// sources (flash_attention.cu, and the decode sources through
// decode_split.cuh).
#pragma once

#include <cuda_runtime.h>

// Raise `kernel`'s dynamic shared-memory limit on the current device to
// `bytes` only when a launch needs more than the limit already set for
// it there.  `allowed` holds that limit per device index for this one
// kernel (0: the default 48 KB), so cudaFuncSetAttribute runs once per
// kernel and device at a fixed size, not before every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > (allowed[dev] ? allowed[dev] : 48 * 1024)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}
