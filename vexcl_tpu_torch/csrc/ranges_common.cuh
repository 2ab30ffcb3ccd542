// The pieces that the kernels which sort by range share: csrc/scatter.cu
// (the scatter's form A and form B) and csrc/gather.cu (the gather).
// Here: a block-wide exclusive scan of one u32 a thread, and raising a
// kernel's dynamic shared-memory limit once a device.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// exclusive scan of one u32 a thread over the block; *total gets the sum
// (the block's threads all call it; warp_sums holds THREADS / 32 words)
template <int THREADS>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const uint32_t before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// the dynamic shared-memory limit of a kernel, raised once a device to
// what a launch asks
int allow_smem(const void* fn, int bytes, int* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && configured[dev] < bytes) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    configured[dev] = bytes;
  }
  return 0;
}

}  // namespace
