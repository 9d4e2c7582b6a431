// Registers, shared memory and occupancy of a compiled kernel, for the
// build report of the WORp CUDA sources (each exports worp_<name>_info).
#pragma once
#include <cuda_runtime.h>

namespace worp {

// out[0] registers a thread, out[1] static shared memory in bytes, out[2]
// resident blocks per SM at `threads` threads and `dyn_smem` bytes of
// dynamic shared memory, out[3] the dynamic shared memory the kernel may
// use.  Returns a CUDA error code (0 on success).
template <class Kernel>
int kernel_info(Kernel* kernel, int threads, int dyn_smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = blocks;
  out[3] = fa.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace worp
