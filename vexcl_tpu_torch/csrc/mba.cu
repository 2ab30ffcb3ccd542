// MBA's tap sum for Hopper: z[i] = the cubic B-spline of a flattened
// control lattice at point i, for d = 1, 2 or 3 coordinates in f32 or f64
// (ops/mba.py's interpolant; ops/cuda_mba.py is the wrapper).
//
// Replaces the tap sum of V1's generated Triton kernel (an elementwise
// tree of 4^d PointerDeref loads, expr/triton_emit.py), which stands where
// the JAX package has XLA's gathers (vexcl_tpu/ops/mba.py:164-208).  The
// arithmetic is the tree's, operation by operation and in its order, with
// no contraction into FMAs (the __*_rn intrinsics): per axis k,
//   u = clamp((x - lo) / h, 0, grid - 1e-12)   (NaN kept, as the tree's)
//   i = min(int(floor(u)), grid - 1),  t = u - i,  s = 1 - t,
//   w = (s s s / 6, (3 t^3 - 6 t^2 + 4) / 6,
//        (-3 t^3 + 3 t^2 + 3 t + 1) / 6, t^3 / 6),
// then the 4^d terms (w_0 w_1 ... w_{d-1}) * tap summed left to right in
// the order of itertools.product(range(4), repeat=d).
//
// What bounds it on this card: device memory sees 12 bytes a 2-D f32
// point (two coordinates read, one value written; 0.060 ms at 2^24 points
// at 3.35 TB/s), but each point also reads 4^d taps at random places of a
// table that the caches hold (the bench's 259^2 f32 lattice is 268 KB).
// Those scattered reads set the time.  On an H100 80GB HBM3 at 700 W
// (2^24 points of the bench's fit; PERF.md §6 gives the runs) four ways of reading them all took 6-8 SM cycles a point: the
// lattice by 16 scalar loads (381 us f32), its rows padded to 16-byte
// words and read by two 16-byte loads each (388), a 4x table read by one
// 16-byte load a row from L2 (486), and the lattice in bands of 128 rows
// in shared memory, each chunk of points listed by band (405); so the
// rate of scattered accesses of the SM's L1/shared-memory path, not their
// width or count of instructions, holds it.  The table's layout is tied to
// the type, the one that won it (Fetch):
//   float   the lattice itself, four scalar loads a row (the 268 KB lattice
//           mostly in L1);
//   double  a 4x table whose entry j holds lattice[j .. j+3] along the last
//           axis, two 16-byte loads a row (569 us against the lattice's
//           800, whose 537 KB misses L1).
// A thread takes four consecutive points: coordinates read with 16-byte
// streaming loads (__ldcs), the result written with 16-byte streaming
// stores (__stcs), so that they do not evict the table, and the four
// points' row loads are independent, in flight together.  The kernel asks
// for the largest L1 (no shared memory).
//
// Plain C interface for ctypes: the entry launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error of
// its launch (0 when it was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4;  // consecutive points a thread

template <typename T>
struct Args {
  const T* x[3];   // the coordinates, n each (x[k] for k < d)
  const T* tab;    // the table of T's layout (Fetch)
  T* out;
  int64_t n;
  T lo[3], h[3];   // the domain's start and the cell size, in T
  T top[3];        // grid - 1e-12, in T (the clamp's upper end)
  int last[3];     // grid - 1: the largest base index
  int stride[3];   // table entries a step of each axis (the last: 1)
  int aligned;     // every coordinate and out 16-byte aligned
};

// the tree's operations, correctly rounded and never contracted
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }

// four consecutive coordinates from p (`left` of them valid)
__device__ __forceinline__ void load4(const float* p, bool whole,
                                      int64_t left, float (&v)[kPoints]) {
  if (whole) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j) v[j] = j < left ? __ldcs(p + j) : 0.f;
}

__device__ __forceinline__ void load4(const double* p, bool whole,
                                      int64_t left, double (&v)[kPoints]) {
  if (whole) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j) v[j] = j < left ? __ldcs(p + j) : 0.0;
}

__device__ __forceinline__ void store4(float* p, bool whole, int64_t left,
                                       const float (&v)[kPoints]) {
  if (whole) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j)
    if (j < left) __stcs(p + j, v[j]);
}

__device__ __forceinline__ void store4(double* p, bool whole, int64_t left,
                                       const double (&v)[kPoints]) {
  if (whole) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
    __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j)
    if (j < left) __stcs(p + j, v[j]);
}

// the four taps of the row whose first tap is table entry p: in float the
// lattice itself, in double the 4x table (four entries a control)
template <typename T>
struct Fetch;

template <>
struct Fetch<float> {
  static __device__ __forceinline__ void row(const float* __restrict__ tab,
                                             int p, float (&v)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(tab + p + j);
  }
};

template <>
struct Fetch<double> {
  static __device__ __forceinline__ void row(const double* __restrict__ tab,
                                             int p, double (&v)[4]) {
    const double2* q =
        reinterpret_cast<const double2*>(tab) + 2 * static_cast<int64_t>(p);
    const double2 a = __ldg(q), b = __ldg(q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

// the clamped coordinate u and the base index i of axis k at x
template <typename T>
__device__ __forceinline__ int base_index(const Args<T>& a, int k, T x,
                                          T& u) {
  u = div_(sub_(x, a.lo[k]), a.h[k]);
  u = u < T(0) ? T(0) : u;  // NaN stays NaN, as the tree's clamp
  u = u > a.top[k] ? a.top[k] : u;
  const int i = u >= T(0) ? static_cast<int>(floor(u)) : 0;
  return i < a.last[k] ? i : a.last[k];
}

// the interpolant at one point (coordinates c)
template <typename T, int D>
__device__ __forceinline__ T point(const Args<T>& a, const T (&c)[D]) {
  T w[D][4];
  int base = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T u;
    const int i = base_index(a, k, c[k], u);
    const T t = sub_(u, static_cast<T>(i));
    const T s = sub_(T(1), t);
    const T t2 = mul_(t, t);
    const T t3 = mul_(t2, t);
    w[k][0] = div_(mul_(mul_(s, s), s), T(6));
    w[k][1] = div_(add_(sub_(mul_(T(3), t3), mul_(T(6), t2)), T(4)), T(6));
    w[k][2] = div_(add_(add_(add_(mul_(T(-3), t3), mul_(T(3), t2)),
                             mul_(T(3), t)), T(1)), T(6));
    w[k][3] = div_(t3, T(6));
    base += i * a.stride[k];
  }
  constexpr int kRowsOfBox = D == 1 ? 1 : (D == 2 ? 4 : 16);
  T v[kRowsOfBox][4];
#pragma unroll
  for (int r = 0; r < kRowsOfBox; ++r) {
    int p = base;
    if constexpr (D == 2) p += r * a.stride[0];
    if constexpr (D == 3) p += (r >> 2) * a.stride[0] + (r & 3) * a.stride[1];
    Fetch<T>::row(a.tab, p, v[r]);
  }
  T acc = T(0);
#pragma unroll
  for (int r = 0; r < kRowsOfBox; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T wt;
      if constexpr (D == 1) {
        wt = w[0][j];
      } else if constexpr (D == 2) {
        wt = mul_(w[0][r], w[1][j]);
      } else {
        wt = mul_(mul_(w[0][r >> 2], w[1][r & 3]), w[2][j]);
      }
      const T term = mul_(wt, v[r][j]);
      acc = (r == 0 && j == 0) ? term : add_(acc, term);
    }
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) mba_kernel(const Args<T> a) {
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPoints;
  if (first >= a.n) return;
  const int64_t left = a.n - first;
  const bool whole = a.aligned && left >= kPoints;
  T xc[D][kPoints];
#pragma unroll
  for (int k = 0; k < D; ++k) load4(a.x[k] + first, whole, left, xc[k]);
  T z[kPoints];
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    T c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = xc[k][q];
    z[q] = point<T, D>(a, c);
  }
  store4(a.out + first, whole, left, z);
}

template <typename T, int D>
int launch(const Args<T>& a, cudaStream_t stream) {
  static bool carved = false;  // the largest L1: the kernel has no smem
  if (!carved) {
    const cudaError_t e = cudaFuncSetAttribute(
        mba_kernel<T, D>, cudaFuncAttributePreferredSharedMemoryCarveout,
        0);
    if (e != cudaSuccess) return static_cast<int>(e);
    carved = true;
  }
  const int64_t threads = (a.n + kPoints - 1) / kPoints;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  mba_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int eval(int d, const void* const* x, const void* tab, void* out,
         int64_t n, const double* lo, const double* h, const int* grid,
         cudaStream_t stream) {
  Args<T> a{};
  for (int k = 0; k < 3; ++k) a.x[k] = static_cast<const T*>(x[k]);
  a.tab = static_cast<const T*>(tab);
  a.out = static_cast<T*>(out);
  a.n = n;
  bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int k = 0; k < d; ++k) {
    a.lo[k] = static_cast<T>(lo[k]);
    a.h[k] = static_cast<T>(h[k]);
    a.top[k] = static_cast<T>(static_cast<double>(grid[k]) - 1e-12);
    a.last[k] = grid[k] - 1;
    aligned = aligned && (reinterpret_cast<uintptr_t>(x[k]) & 15) == 0;
  }
  a.aligned = aligned;
  // the table's entries as the lattice's: the last axis contiguous
  int s = 1;
  for (int k = d - 1; k >= 0; --k) {
    a.stride[k] = s;
    s *= grid[k] + 3;
  }
  switch (d) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out[i] = the interpolant at (x0[i], ..., x_{d-1}[i]), i < n; f64 selects
// double coordinates, table and out (else float).  d = 1, 2 or 3 axes of
// grid[k] cells (grid[k] + 3 controls), the domain starting at lo[k] with
// cells of h[k]; the table in the type's layout (float: the lattice,
// double: four entries a control); fewer than 2^31 table entries.
int vex_mba_eval(int f64, int d, const void* x0, const void* x1,
                 const void* x2, const void* tab, void* out, int64_t n,
                 double lo0, double lo1, double lo2, double h0, double h1,
                 double h2, int g0, int g1, int g2, void* stream) {
  if (d < 1 || d > 3 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* x[3] = {x0, x1, x2};
  const double lo[3] = {lo0, lo1, lo2};
  const double h[3] = {h0, h1, h2};
  const int grid[3] = {g0, g1, g2};
  for (int k = 0; k < d; ++k) {
    if (grid[k] < 1 || x[k] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? eval<double>(d, x, tab, out, n, lo, h, grid, s)
             : eval<float>(d, x, tab, out, n, lo, h, grid, s);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
