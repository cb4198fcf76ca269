// A launch's geometry and a kernel's attributes, as every kernel library
// here reports them through its `<prefix>_plan` and `<prefix>_attributes`
// exports (kernels/*/kernel.py `launch_plan` mirrors the geometry in
// Python; analysis/kernel_lint.py holds the two equal on the card).
#pragma once
#include <cuda_runtime.h>

namespace {

// Grid, block and dynamic shared memory of one launch, and which of the
// launcher's kernel instances it takes (0 where there is one). A launcher
// launches by the Plan its plan function returns, and `<prefix>_plan`
// reports the same Plan.
struct Plan {
  dim3 grid, block;
  unsigned smem;
  int variant;
};

// out = {grid x, y, z, block x, y, z, dynamic shared bytes}
inline void write_plan(const Plan& p, int* out) {
  out[0] = (int)p.grid.x;
  out[1] = (int)p.grid.y;
  out[2] = (int)p.grid.z;
  out[3] = (int)p.block.x;
  out[4] = (int)p.block.y;
  out[5] = (int)p.block.z;
  out[6] = (int)p.smem;
}

// out = {registers a thread, local bytes a thread, static shared bytes, the
// most dynamic shared bytes, the most threads a block, blocks an SM at the
// plan's block and shared memory} of kernel `fn` on the current device.
// Above 48 KB it first sets the kernel's dynamic shared memory limit to the
// plan's, as its launcher does before launching.
inline cudaError_t write_attributes(const void* fn, const Plan& p, int* out) {
  cudaError_t err = cudaSuccess;
  if (p.smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, (int)(p.block.x * p.block.y * p.block.z), p.smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  out[5] = blocks;
  return cudaSuccess;
}

}  // namespace
