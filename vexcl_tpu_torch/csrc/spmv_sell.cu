// Irregular SpMV for Hopper: SELL-C-sigma (C = 32) and CSR on row blocks.
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
// Slice s holds its rows' slots from slice_ptr[s] (a multiple of 4) as a
// (w_s / 4, 32, 4) plane, w_s a multiple of 4: packet k of lane l is
// slots 4k .. 4k + 3 of the slice's row l, at slice_ptr[s] + 128 k + 4 l.
// So a lane loads four columns with one 16-byte load and four values with
// one (f32) or two (f64), and a warp's load covers 512 (or 1024)
// neighbouring bytes: coalesced.  Rows were sorted by length inside
// windows of sigma rows on the host, so the 32 rows of a slice have
// similar lengths and little padding; rows longer than the SELLR spill
// length go to the CSR kernel (a slice is no wider than that).  Padding
// slots carry column -1 and are skipped: their value is never multiplied
// (0 * NaN is NaN).  Slice offsets are int64; columns and perm are int32.
//
// What bounds it.  The same gathers as the CSR kernel below (one per
// entry, each a 32-byte L2 sector), plus the padding's bytes of col and
// val.  Taken one slot at a time (a column load, then the value and
// x[col]), each thread keeps about one gather in flight behind its column
// load.  Here a thread issues two packets' column and value
// loads, then their eight gathers, before its first multiply: eight
// independent gathers in flight per thread, as the row blocks of the CSR
// kernel keep many in flight per block.  The row's sum is one register,
// written once to y[perm[r]].
//
// csr_spmv_kernel: CSR-Adaptive (Greathouse and Daga, SC'14) on row
// blocks.  It serves fmt="csr", the CSR tail of the hybrid format and the
// rows too long for SELL.  ``rows`` maps the k-th stored row to its row of
// y (null: the identity); with ``accumulate`` the result adds onto y, which
// the SELL or ELL kernel wrote before on the same stream.  ptr is int64.
//
// What bounds it.  On the bench's lognormal matrix (2^20 rows, ~16.4M
// entries, mean 16 a row) the kernel must move 147 MB of device memory
// (col and val once, ptr, x and y), 0.0439 ms at 3.35 TB/s.  Besides, each
// entry gathers x[col] at a random column: ~16.4M 4-byte reads of an x
// (4 MB) that stays in L2, each costing one 32-byte L2 sector, ~525 MB of
// L2 traffic.  A warp per row, as before, left each warp a chain of three
// dependent latencies (ptr -> col -> x) for a row of ~16 entries, with
// half its lanes idle and ~8.4K rows in flight on the card: bound by
// latency, 0.67 TB/s.
//
// The design.  The host cuts the stored rows into row blocks (``blocks``,
// ``cuda_sell.row_blocks``): each block holds at most 256 rows and fewer
// than kBlockEntries entries, or a single row.  A block of several rows
// loads its contiguous run of col and val coalesced (16-byte loads where
// the arrays are aligned), and every thread gathers x for its own entries:
// ~kBlockEntries / 2 independent gathers in flight per block instead of
// one chain per warp.  The products go to shared memory, and each row is
// summed from there by a group of ``tpr`` threads (a power of two, up to a
// warp, as many as the block's row count leaves) with width-``tpr``
// shuffles.  A single-row block (a row longer than kBlockEntries / 2, or
// one left alone by the cuts) is strided by all 256 threads and reduced
// through shuffles and shared memory.  Every sum is taken in a fixed
// order and written once: deterministic, no atomics.
//
// Both kernels are bound by memory: per stored slot 4 bytes of column and
// 4 or 8 of value from device memory, and a gather of x that L2 serves.
// Accumulation is in the value type.  The SELL kernel needs col and val
// 16-byte aligned (the wrapper checks); the CSR kernel takes 16-byte loads
// where they are.
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 32;
constexpr int kThreads = 256;

// a block holds fewer entries than this unless it holds one row; must
// equal cuda_sell.ROW_BLOCK_ENTRIES (and a block at most kThreads rows,
// cuda_sell.ROW_BLOCK_ROWS)
constexpr int kBlockEntries = 2048;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// The products val[k] * x[col[k]] of the four entries g .. g + 3 (g a
// multiple of 4); those outside [e0, e1) are 0 and read nothing.  With
// kVec (col and val 16-byte aligned) a group inside the range takes one
// 16-byte load of columns and one or two of values.
template <typename T, bool kVec>
__device__ __forceinline__ void products4(const int32_t* __restrict__ col,
                                          const T* __restrict__ val,
                                          const T* __restrict__ x, int64_t g,
                                          int64_t e0, int64_t e1,
                                          T (&p)[4]) {
  if (kVec && g >= e0 && g + 4 <= e1) {
    const int4 c = __ldcs(reinterpret_cast<const int4*>(col + g));
    T v[4];
    load4(val + g, v);
    p[0] = v[0] * __ldg(x + c.x);
    p[1] = v[1] * __ldg(x + c.y);
    p[2] = v[2] * __ldg(x + c.z);
    p[3] = v[3] * __ldg(x + c.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t k = g + j;
      p[j] = k >= e0 && k < e1 ? val[k] * __ldg(x + col[k]) : T(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, int32_t c) {
  return c >= 0 ? __ldg(x + c) : T(0);
}

// sum += the four products of one packet (values v, gathered x g), in
// slot order
template <typename T>
__device__ __forceinline__ void fma_packet(T& sum, const T (&v)[4],
                                           const T (&g)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) sum += v[j] * g[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const int64_t* __restrict__ slice_ptr,
                     const int32_t* __restrict__ col,
                     const T* __restrict__ val,
                     const int32_t* __restrict__ perm,
                     const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t s = r / kC;
  const int64_t b0 = slice_ptr[s];
  const int64_t packets = (slice_ptr[s + 1] - b0) / (4 * kC);
  const int64_t first = b0 + 4 * (r % kC);   // this lane's packet 0
  T sum = 0;
  int64_t k = 0;
  for (; k + 2 <= packets; k += 2) {
    const int64_t o0 = first + k * 4 * kC;
    const int64_t o1 = o0 + 4 * kC;
    const int4 c0 = __ldcs(reinterpret_cast<const int4*>(col + o0));
    const int4 c1 = __ldcs(reinterpret_cast<const int4*>(col + o1));
    T v0[4], v1[4];
    load4(val + o0, v0);
    load4(val + o1, v1);
    const T g0[4] = {gather(x, c0.x), gather(x, c0.y), gather(x, c0.z),
                     gather(x, c0.w)};
    const T g1[4] = {gather(x, c1.x), gather(x, c1.y), gather(x, c1.z),
                     gather(x, c1.w)};
    fma_packet(sum, v0, g0);
    fma_packet(sum, v1, g1);
  }
  if (k < packets) {
    const int64_t o0 = first + k * 4 * kC;
    const int4 c0 = __ldcs(reinterpret_cast<const int4*>(col + o0));
    T v0[4];
    load4(val + o0, v0);
    const T g0[4] = {gather(x, c0.x), gather(x, c0.y), gather(x, c0.z),
                     gather(x, c0.w)};
    fma_packet(sum, v0, g0);
  }
  y[perm != nullptr ? static_cast<int64_t>(perm[r]) : r] = sum;
}

template <typename T>
__device__ __forceinline__ void put_row(T* __restrict__ y,
                                        const int32_t* __restrict__ rows,
                                        int64_t r, T sum, int accumulate) {
  const int64_t row = rows != nullptr ? static_cast<int64_t>(rows[r]) : r;
  y[row] = accumulate ? y[row] + sum : sum;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_kernel(const int64_t* __restrict__ ptr,
                    const int32_t* __restrict__ col,
                    const T* __restrict__ val,
                    const int32_t* __restrict__ blocks,
                    const int32_t* __restrict__ rows,
                    const T* __restrict__ x, T* __restrict__ y,
                    int accumulate) {
  __shared__ T prod[kBlockEntries];
  __shared__ int64_t rptr[kThreads + 1];
  const int64_t r0 = blocks[blockIdx.x];
  const int nr = static_cast<int>(blocks[blockIdx.x + 1] - r0);
  for (int i = threadIdx.x; i <= nr; i += kThreads) rptr[i] = ptr[r0 + i];
  __syncthreads();
  const int64_t e0 = rptr[0];
  const int64_t e1 = rptr[nr];
  const int64_t a0 = e0 & ~int64_t{3};  // the first group of four
  const int lane = threadIdx.x % kC;

  if (nr == 1) {  // one row: all threads stride it
    T sum = 0;
#pragma unroll 2
    for (int64_t g = a0 + 4 * threadIdx.x; g < e1; g += 4 * kThreads) {
      T p[4];
      products4<T, kVec>(col, val, x, g, e0, e1, p);
      sum += (p[0] + p[1]) + (p[2] + p[3]);
    }
    for (int o = kC / 2; o > 0; o /= 2) {
      sum += __shfl_down_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) prod[threadIdx.x / kC] = sum;
    __syncthreads();
    if (threadIdx.x < kC) {
      sum = threadIdx.x < kThreads / kC ? prod[threadIdx.x] : T(0);
      for (int o = kC / 2; o > 0; o /= 2) {
        sum += __shfl_down_sync(0xffffffffu, sum, o);
      }
      if (threadIdx.x == 0) put_row(y, rows, r0, sum, accumulate);
    }
    return;
  }

  // several rows, fewer than kBlockEntries entries: stage the products
  for (int64_t g = a0 + 4 * threadIdx.x; g < e1; g += 4 * kThreads) {
    T p[4];
    products4<T, kVec>(col, val, x, g, e0, e1, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t k = g + j;
      if (k >= e0 && k < e1) prod[k - e0] = p[j];
    }
  }
  __syncthreads();
  // tpr threads per row: nr * tpr <= kThreads, so one pass covers the
  // block and every thread reaches the shuffles
  int tpr = kC;
  while (tpr > 1 && nr * tpr > kThreads) tpr /= 2;
  const int r = threadIdx.x / tpr;
  const int sub = threadIdx.x % tpr;
  T sum = 0;
  if (r < nr) {
    const int end = static_cast<int>(rptr[r + 1] - e0);
    for (int k = static_cast<int>(rptr[r] - e0) + sub; k < end; k += tpr) {
      sum += prod[k];
    }
  }
  for (int o = tpr / 2; o > 0; o /= 2) {
    sum += __shfl_down_sync(0xffffffffu, sum, o, tpr);
  }
  if (sub == 0 && r < nr) put_row(y, rows, r0 + r, sum, accumulate);
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
               const void* blocks, const void* rows, const void* x, void* y,
               int64_t nblocks, int accumulate, void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(col) |
                     reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  auto kernel = vec ? csr_spmv_kernel<T, true> : csr_spmv_kernel<T, false>;
  kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(col),
      static_cast<const T*>(val), static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(rows), static_cast<const T*>(x),
      static_cast<T*>(y), accumulate);
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
                     const void* blocks, const void* rows, const void* x,
                     void* y, int64_t nblocks, int accumulate, void* stream) {
  return launch_csr<float>(ptr, col, val, blocks, rows, x, y, nblocks,
                           accumulate, stream);
}

int vex_csr_spmv_f64(const void* ptr, const void* col, const void* val,
                     const void* blocks, const void* rows, const void* x,
                     void* y, int64_t nblocks, int accumulate, void* stream) {
  return launch_csr<double>(ptr, col, val, blocks, rows, x, y, nblocks,
                            accumulate, stream);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
