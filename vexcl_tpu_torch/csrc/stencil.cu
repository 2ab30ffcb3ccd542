// 1-D stencil for Hopper: y[i] = sum_k c[k] * x[clamp(i + k - center)].
//
// Replaces the Pallas kernel of vexcl_tpu/ops/pallas_stencil.py
// (_kernel, called through stencil_pallas).  That kernel views x as
// (rows, 128) lanes, DMAs each block's window with an 8-row halo into VMEM
// and forms the flat shifts from lane rolls; the halo rows limit its taps
// to |k - center| <= 1024, and it runs f32 only.  None of that carries
// over.  Here:
//
// * stencil_tile_kernel: a block computes kTile consecutive outputs.  It
//   stages the taps and the tile's inputs plus the width - 1 halo elements
//   in shared memory once, then each thread sums its outputs from there.
//   Every element of x is read from device memory about once, so the
//   kernel is bound by one read and one write of n elements;
// * stencil_l2_kernel: for taps too wide for the tile (the wrapper picks
//   it when taps + tile + halo exceed kSmemBytes) each thread reads its
//   taps straight from x through the L1 and L2 caches.  No width is left
//   to another path;
// * the ends are replicated by clamping the input index to [0, n - 1]
//   (vexcl/stencil.hpp:138-154), which also covers n < width;
// * sums run in the output type TO, the promotion of the input type TX and
//   the tap type TC, in tap order, as the JAX package's XLA form does.
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr size_t kSmemBytes = 48 * 1024;

__device__ __forceinline__ int64_t clamp_index(int64_t j, int64_t n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

template <typename TX, typename TC, typename TO>
__global__ void stencil_tile_kernel(const TX* __restrict__ x,
                                    const TC* __restrict__ coeff,
                                    TO* __restrict__ y, int64_t n, int width,
                                    int center) {
  // taps first: sizeof(TO) >= sizeof(TX), so the tile stays aligned
  extern __shared__ __align__(16) unsigned char smem[];
  TO* taps = reinterpret_cast<TO*>(smem);
  TX* tile = reinterpret_cast<TX*>(smem + sizeof(TO) * width);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    taps[k] = static_cast<TO>(coeff[k]);
  }
  const int span = kTile + width - 1;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    tile[t] = x[clamp_index(base - center + t, n)];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTile && base + t < n; t += blockDim.x) {
    TO acc = 0;
    for (int k = 0; k < width; ++k) {
      acc += taps[k] * static_cast<TO>(tile[t + k]);
    }
    y[base + t] = acc;
  }
}

template <typename TX, typename TC, typename TO>
__global__ void stencil_l2_kernel(const TX* __restrict__ x,
                                  const TC* __restrict__ coeff,
                                  TO* __restrict__ y, int64_t n, int width,
                                  int center) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  TO acc = 0;
  for (int k = 0; k < width; ++k) {
    acc += static_cast<TO>(__ldg(coeff + k)) *
           static_cast<TO>(__ldg(x + clamp_index(i + k - center, n)));
  }
  y[i] = acc;
}

template <typename TX, typename TC, typename TO>
int launch(const void* x, const void* coeff, void* y, int64_t n, int64_t width,
           int64_t center, void* stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* cp = static_cast<const TC*>(coeff);
  auto* yp = static_cast<TO*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(TO) * width + sizeof(TX) * (kTile + width - 1);
  if (smem <= kSmemBytes) {
    const int64_t blocks = (n + kTile - 1) / kTile;
    stencil_tile_kernel<TX, TC, TO><<<static_cast<unsigned>(blocks), kThreads,
                                      smem, st>>>(
        xp, cp, yp, n, static_cast<int>(width), static_cast<int>(center));
  } else {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    stencil_l2_kernel<TX, TC, TO><<<static_cast<unsigned>(blocks), kThreads,
                                    0, st>>>(
        xp, cp, yp, n, static_cast<int>(width), static_cast<int>(center));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vex_stencil_<x type>_<tap type>; the output is the promoted type.
int vex_stencil_f32_f32(const void* x, const void* coeff, void* y, int64_t n,
                        int64_t width, int64_t center, void* stream) {
  return launch<float, float, float>(x, coeff, y, n, width, center, stream);
}

int vex_stencil_f32_f64(const void* x, const void* coeff, void* y, int64_t n,
                        int64_t width, int64_t center, void* stream) {
  return launch<float, double, double>(x, coeff, y, n, width, center, stream);
}

int vex_stencil_f64_f32(const void* x, const void* coeff, void* y, int64_t n,
                        int64_t width, int64_t center, void* stream) {
  return launch<double, float, double>(x, coeff, y, n, width, center, stream);
}

int vex_stencil_f64_f64(const void* x, const void* coeff, void* y, int64_t n,
                        int64_t width, int64_t center, void* stream) {
  return launch<double, double, double>(x, coeff, y, n, width, center, stream);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
