// A kernel build's registers, local memory and occupancy, for the C entry
// points that report them (knn.cu's graph kernel, fps.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// info = {registers, local bytes a thread, dynamic shared bytes, resident
// blocks per SM} of `kernel` at `smem` dynamic shared bytes and `threads` a
// block.
template <typename K>
cudaError_t kernel_info(K kernel, size_t smem, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[3] = blocks;
  return err;
}

}  // namespace
