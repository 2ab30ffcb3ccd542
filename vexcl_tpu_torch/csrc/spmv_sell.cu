// Irregular SpMV for Hopper: SELL-C-sigma (C = 32) and CSR-vector.
//
// Replaces the thirteen Pallas kernels of vexcl_tpu/sparse/shuffle.py that
// together compute y = A x for an irregular A (SELLR.apply).  On the TPU
// there is no fast gather, so that pipeline expands x per entry slot
// (_expand_gather, _expand_gather_vmem, _expand_gather_vmem_T), routes the
// slots through a Benes network into width-class order (_lane_perm,
// _sub_perm, _subk_perm, _lslk_perm, _lsl_perm, _t_pallas, _tinv_pallas,
// _lane_t, _tinv_lane), sums each class's columns (_class_colsum_dma) and
// routes y back.  The H100 gathers from L2 directly, so here:
//
// * expand: each thread reads x[col] itself (x of a 2^20-row matrix is
//   4 MB and stays in the 50 MB L2 cache);
// * route: nothing to do.  The stored planes are already in slot order,
//   and the row permutation is applied at the single store, y[perm[r]];
// * column sums: each thread accumulates its own row in a register.
//
// sell_spmv_kernel: one thread per row, one warp per slice of 32 rows.
// Slice s holds its (w_s, 32) column and value planes column-major from
// slice_ptr[s], so at every step the warp reads 32 neighbouring int32
// columns and 32 neighbouring values: coalesced.  Rows were sorted by
// length inside windows of sigma rows on the host, so the 32 rows of a
// slice have similar lengths and little padding.  Padding slots carry
// column -1 and are skipped: their value is never multiplied (0 * NaN is
// NaN).  Slice offsets are int64; columns and perm are int32.
//
// csr_spmv_kernel: one warp per row; the lanes stride over the row's
// entries and a warp shuffle sums them.  It serves fmt="csr", the CSR tail
// of the hybrid format and the rows too long for SELL (a warp splits such
// a row 32 ways where SELL would leave it to one thread).  ``rows`` maps
// the k-th stored row to its row of y (null: the identity); with
// ``accumulate`` the result adds onto y, which the SELL or ELL kernel wrote
// before on the same stream.  ptr is int64.
//
// Both kernels are bound by memory: per stored slot 4 bytes of column and
// 4 or 8 of value from device memory, and a gather of x that L2 serves.
// Accumulation is in the value type.
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;
constexpr int kThreads = 256;

template <typename T>
__global__ void sell_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                                 const int32_t* __restrict__ col,
                                 const T* __restrict__ val,
                                 const int32_t* __restrict__ perm,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t n) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t s = r / kC;
  const int64_t end = slice_ptr[s + 1];
  T sum = 0;
#pragma unroll 4
  for (int64_t k = slice_ptr[s] + (r % kC); k < end; k += kC) {
    const int32_t c = col[k];
    if (c >= 0) sum += val[k] * __ldg(x + c);
  }
  y[perm != nullptr ? static_cast<int64_t>(perm[r]) : r] = sum;
}

template <typename T>
__global__ void csr_spmv_kernel(const int64_t* __restrict__ ptr,
                                const int32_t* __restrict__ col,
                                const T* __restrict__ val,
                                const int32_t* __restrict__ rows,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t nrows, int accumulate) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kC;
  const int lane = threadIdx.x % kC;
  if (w >= nrows) return;  // the whole warp leaves together
  const int64_t end = ptr[w + 1];
  T sum = 0;
  for (int64_t k = ptr[w] + lane; k < end; k += kC) {
    sum += val[k] * __ldg(x + col[k]);
  }
  for (int o = kC / 2; o > 0; o /= 2) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  }
  if (lane == 0) {
    const int64_t row = rows != nullptr ? static_cast<int64_t>(rows[w]) : w;
    y[row] = accumulate ? y[row] + sum : sum;
  }
}

template <typename T>
int launch_sell(const void* slice_ptr, const void* col, const void* val,
                const void* perm, const void* x, void* y, int64_t n,
                void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sell_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slice_ptr), static_cast<const int32_t*>(col),
      static_cast<const T*>(val), static_cast<const int32_t*>(perm),
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_csr(const void* ptr, const void* col, const void* val,
               const void* rows, const void* x, void* y, int64_t nrows,
               int accumulate, void* stream) {
  const int64_t rows_per_block = kThreads / kC;
  const int64_t blocks = (nrows + rows_per_block - 1) / rows_per_block;
  csr_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(col),
      static_cast<const T*>(val), static_cast<const int32_t*>(rows),
      static_cast<const T*>(x), static_cast<T*>(y), nrows, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vex_sell_spmv_f32(const void* slice_ptr, const void* col, const void* val,
                      const void* perm, const void* x, void* y, int64_t n,
                      void* stream) {
  return launch_sell<float>(slice_ptr, col, val, perm, x, y, n, stream);
}

int vex_sell_spmv_f64(const void* slice_ptr, const void* col, const void* val,
                      const void* perm, const void* x, void* y, int64_t n,
                      void* stream) {
  return launch_sell<double>(slice_ptr, col, val, perm, x, y, n, stream);
}

int vex_csr_spmv_f32(const void* ptr, const void* col, const void* val,
                     const void* rows, const void* x, void* y, int64_t nrows,
                     int accumulate, void* stream) {
  return launch_csr<float>(ptr, col, val, rows, x, y, nrows, accumulate,
                           stream);
}

int vex_csr_spmv_f64(const void* ptr, const void* col, const void* val,
                     const void* rows, const void* x, void* y, int64_t nrows,
                     int accumulate, void* stream) {
  return launch_csr<double>(ptr, col, val, rows, x, y, nrows, accumulate,
                            stream);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
