// Assignment through a permutation for Hopper: out[p[i]] = v[i], or the
// atomic add, min or max of v[i] at p[i], for f32, f64, i32 and i64
// targets.
//
// Replaces the generated Triton kernel of V3 (expr/triton_emit.py,
// assign_to_view: one program a block, each lane one tl.store or
// tl.atomic_* at its index) for the forms it routes here
// (ops/cuda_scatter.py, route), and so stands where the JAX package has
// XLA's scatter (vexcl_tpu/expr/view.py:60-100 and
// vexcl_tpu/ops/atomic.py:57-124, `.at[idx].set/add/min/max`).  The index
// rule is the reference's: the index is truncated to i32, a negative one
// wraps once by +N, and the rest out of range is dropped.
//
// What bounds the single-pass scatter on this card: each 4-byte store or
// atomic goes to its own 32-byte sector.  A target larger than the 50 MB
// L2 (2^24 f32 is 64 MB) leaves each sector partly written, and the L2
// fills and evicts it in device memory: ~190 bytes of traffic a 4-byte
// store, 966 us for 2^24 f32 against a 60 us bound.  Atomics into a small
// target (a histogram of 2^24 keys into 2^16 bins) stay in L2 and are
// bound by the L2's contended atomics, 238 us against a 20 us bound.
// Both have the same cure: group the updates by destination range and
// combine each range in shared memory, so that device memory sees only
// coalesced reads and whole-sector writes.
//
// Form A, the scatter by destination range (large targets).  The target
// is cut into ranges of R = 2^log_r elements (R * sizeof(T) of shared
// memory, 128 KB by default), the updates into tiles of `tile` updates:
//
//   (a) count_kernel: each tile counts its valid updates per range in
//       shared memory and writes its row of a (tile, range) matrix;
//   (b) rowscan_kernel: one block per range scans its column over the
//       tiles (exclusive) and writes the range's total.  The matrix (up
//       to 1024 tiles: 2 MB at 2^24 f32) stays in L2, so this pass costs
//       a few microseconds; a look-back inside (a) would save one launch
//       but needs a ticket and status words per tile, for ~3 us;
//   (c) distribute_kernel: each tile reads its updates again and places
//       each one at its range's next slot of the tile in shared memory
//       (a shared-memory atomic on the range's count), then writes the
//       tile's (offset within the range as u16, value) pairs out one warp
//       a range: the pairs of all the tiles are range-major, and one
//       (tile, range) pair's updates land as one run of neighbouring
//       stores.  Within a run the pairs are in the atomics' order, not
//       the index's: (d) applies a range's pairs all at once, so no
//       mode's result depends on their order, and a stable ranking (one
//       ballot a bit of the range, per-warp counts and a scan over the
//       warps each round) made this kernel the slowest of the four;
//   (d) build_kernel: one block per range that received updates loads the
//       R target elements into shared memory in 16-byte loads, applies
//       its pairs (a store, or a shared-memory atomic for add, min, max)
//       and writes the range back whole in 16-byte stores.  A range with
//       no updates is not touched.
//
// At 2^24 f32 through a permutation this moves ~520 MB, none of it at
// random: (a) reads 64 MB of indices, (c) 128 MB and writes 96 MB of
// pairs, (d) reads 96 MB of pairs and 64 MB of target and writes 64 MB;
// ~0.16 ms at 3.35 TB/s.  With a scalar value no value is moved.
//
// Form B, privatized updates (targets of a few shared-memory windows).
// Each block takes a window of the target in shared memory (the identity
// of the mode), combines the updates of its share that fall in the window
// with shared-memory atomics, and merges its copy into the target with
// one coalesced global atomic per element it changed.  A window is 128 KB
// of the target, so the histogram's 2^16 i32 bins take two windows, each
// block reading its share of the keys once a window (128 MB in all).  Two
// 16-bit counters a word would fit the bins in one window and read the
// keys once, but were slower at 2^16 bins on an H100 (68.3 against 62.4
// us; PERF.md §6), so one form-B kernel serves every mode.
//
// Float min and max combine as PyTorch's scatter_reduce_ amin/amax on the
// card (ATen/cuda/Atomic.cuh, safe_max(val, old)): a NaN in the target
// stays, a NaN value lands, and of two equal values (+0.0 and -0.0) the
// new one lands.  Float adds land in no fixed order.
//
// Plain C interface for ctypes: each entry launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error of
// its launches (0 when they were accepted).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "ranges_common.cuh"

namespace {

constexpr int kThreads = 512;              // (a), (b), (c)
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // updates a thread in (c)
constexpr int kChunk = kThreads * kItems;  // a tile is whole rounds of it
constexpr int kCountUnroll = 4;         // 16-byte loads a thread in (a)
constexpr int kBuildThreads = 1024;        // (d)
constexpr int kBuildUnroll = 4;
constexpr int kPrivThreads = 1024;         // form B
constexpr int kPrivUnroll = 4;

enum Mode { kStore = 0, kAdd = 1, kMin = 2, kMax = 3 };


// the reference's index rule: truncate to i32, wrap a negative index once
// by +N, drop the rest out of range (-1)
template <typename I>
__device__ __forceinline__ int target_index(I raw, int N) {
  int j = static_cast<int>(static_cast<uint32_t>(raw));
  j = j < 0 ? j + N : j;
  return static_cast<unsigned>(j) < static_cast<unsigned>(N) ? j : -1;
}

template <int B>
struct Bits {
  using type = typename std::conditional<B == 8, unsigned long long,
                                         uint32_t>::type;
};

template <typename T>
using BitsOf = typename Bits<static_cast<int>(sizeof(T))>::type;

template <typename T>
__device__ __forceinline__ BitsOf<T> to_bits(T v) {
  BitsOf<T> b;
  memcpy(&b, &v, sizeof(T));
  return b;
}

template <typename T>
__device__ __forceinline__ T from_bits(BitsOf<T> b) {
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

// PyTorch's combine on the card (safe_max(val, old) / safe_min(val, old))
template <typename T, int M>
__device__ __forceinline__ T min_max(T old, T v) {
  if constexpr (M == kMax) return old != old ? old : (v < old ? old : v);
  return old != old ? old : (old < v ? old : v);
}

template <typename T, int M>
__device__ __forceinline__ T identity() {
  if constexpr (M == kAdd) {
    return static_cast<T>(std::is_floating_point<T>::value ? -0.0 : 0.0);
  } else if constexpr (std::is_same<T, float>::value) {
    return M == kMin ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
  } else if constexpr (std::is_same<T, double>::value) {
    return M == kMin ? __longlong_as_double(0x7ff0000000000000ll)
                     : __longlong_as_double(static_cast<long long>(
                           0xfff0000000000000ull));
  } else if constexpr (sizeof(T) == 4) {
    return static_cast<T>(M == kMin ? 0x7fffffff : (-0x7fffffff - 1));
  } else {
    return static_cast<T>(M == kMin ? 0x7fffffffffffffffll
                                    : (-0x7fffffffffffffffll - 1));
  }
}

__device__ __forceinline__ void atomic_add(float* a, float v) {
  atomicAdd(a, v);
}
__device__ __forceinline__ void atomic_add(double* a, double v) {
  atomicAdd(a, v);
}
__device__ __forceinline__ void atomic_add(int32_t* a, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(a), static_cast<int>(v));
}
__device__ __forceinline__ void atomic_add(int64_t* a, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(a),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void atomic_min_max(int32_t* a, int32_t v,
                                               bool is_max) {
  if (is_max) {
    atomicMax(reinterpret_cast<int*>(a), static_cast<int>(v));
  } else {
    atomicMin(reinterpret_cast<int*>(a), static_cast<int>(v));
  }
}
__device__ __forceinline__ void atomic_min_max(int64_t* a, int64_t v,
                                               bool is_max) {
  if (is_max) {
    atomicMax(reinterpret_cast<long long*>(a), static_cast<long long>(v));
  } else {
    atomicMin(reinterpret_cast<long long*>(a), static_cast<long long>(v));
  }
}

// combine v into *a by the mode, atomically but for a store (a shared or a
// global address: the generic atomics serve both)
template <typename T, int M>
__device__ __forceinline__ void combine(T* a, T v) {
  if constexpr (M == kStore) {
    *a = v;
  } else if constexpr (M == kAdd) {
    atomic_add(a, v);
  } else if constexpr (std::is_integral<T>::value) {
    atomic_min_max(a, v, M == kMax);
  } else {
    using U = BitsOf<T>;
    U* ua = reinterpret_cast<U*>(a);
    U old = *reinterpret_cast<volatile U*>(ua);
    while (true) {
      const U nb = to_bits(min_max<T, M>(from_bits<T>(old), v));
      if (nb == old) break;
      const U seen = atomicCAS(ua, old, nb);
      if (seen == old) break;
      old = seen;
    }
  }
}

// ---------------------------------------------------------------------------
// Form A
// ---------------------------------------------------------------------------

// (a) counts[t * ranges + r]: tile t's valid updates into range r
template <typename I>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const I* __restrict__ idx, int64_t n, int N, int log_r,
                 int ranges, int64_t tile, uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  for (int r = threadIdx.x; r < ranges; r += kThreads) hist[r] = 0;
  __syncthreads();
  const int64_t t = blockIdx.x;
  const int64_t begin = t * tile;
  const int64_t end = begin + tile < n ? begin + tile : n;
  // 16 bytes of indices a load where they are aligned (a tile starts at a
  // multiple of kChunk), the rest one a load
  constexpr int kVec = 16 / static_cast<int>(sizeof(I));
  int64_t from = begin;
  if ((reinterpret_cast<uintptr_t>(idx) & 15) == 0) {
    const int64_t vend = begin + (end - begin) / kVec * kVec;
    for (int64_t i0 = begin; i0 < vend; i0 += kThreads * kVec * kCountUnroll) {
      uint4 q[kCountUnroll];
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u) {
        const int64_t i = i0 + (u * kThreads + threadIdx.x) * kVec;
        if (i < vend) q[u] = *reinterpret_cast<const uint4*>(idx + i);
      }
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u) {
        const int64_t i = i0 + (u * kThreads + threadIdx.x) * kVec;
        if (i < vend) {
          const I* e = reinterpret_cast<const I*>(&q[u]);
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            const int j = target_index(e[c], N);
            if (j >= 0) atomicAdd(&hist[j >> log_r], 1u);
          }
        }
      }
    }
    from = vend;
  }
  for (int64_t i = from + threadIdx.x; i < end; i += kThreads) {
    const int j = target_index(idx[i], N);
    if (j >= 0) atomicAdd(&hist[j >> log_r], 1u);
  }
  __syncthreads();
  uint32_t* row = counts + t * ranges;
  for (int r = threadIdx.x; r < ranges; r += kThreads) row[r] = hist[r];
}

// (b) in place, counts[t * ranges + r] becomes the updates of range r in
// tiles before t; totals[r] the range's updates
__global__ void __launch_bounds__(kThreads)
    rowscan_kernel(uint32_t* __restrict__ counts, int64_t tiles, int ranges,
                   uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sums[kWarps];
  const int r = blockIdx.x;
  uint32_t carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {
    const int64_t t = t0 + threadIdx.x;
    const uint32_t v = t < tiles ? counts[t * ranges + r] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan<kThreads>(v, warp_sums, &total);
    if (t < tiles) counts[t * ranges + r] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[r] = carry;
}

// shared memory of (c): the tile's pairs staged in range order (value VB
// bytes, offset u16), then for each range its first place in the target
// pairs and in the staged order and its count so far in the tile (u32)
__host__ __device__ constexpr int distribute_smem(int ranges, int64_t tile,
                                                  int vb) {
  return static_cast<int>(tile) * (vb + 2) + ranges * 12;
}

// (c) the pairs: ppos (offset within the range) and, with values, pval;
// bases[r] (written by tile 0) is range r's first pair.  Each update of
// the tile takes the next place of its range in shared memory (a
// shared-memory atomic on the range's count), and the tile's pairs are
// written out once, one warp a range: each (tile, range) run leaves in
// stores of neighbouring pairs.
template <typename I, int VB>
__global__ void __launch_bounds__(kThreads)
    distribute_kernel(const I* __restrict__ idx, const void* __restrict__ val_,
                      int64_t n, int N, int log_r, int ranges, int64_t tile,
                      int64_t tiles, const uint32_t* __restrict__ offs,
                      const uint32_t* __restrict__ totals,
                      uint32_t* __restrict__ bases,
                      uint16_t* __restrict__ ppos, void* __restrict__ pval_) {
  using V = typename Bits<VB == 0 ? 4 : VB>::type;
  const V* val = static_cast<const V*>(val_);
  V* pval = static_cast<V*>(pval_);
  extern __shared__ __align__(16) unsigned char dsmem[];
  V* sval = reinterpret_cast<V*>(dsmem);
  uint16_t* soff = reinterpret_cast<uint16_t*>(dsmem + tile * VB);
  uint32_t* dest = reinterpret_cast<uint32_t*>(soff + tile);
  uint32_t* start = dest + ranges;
  uint32_t* seen = start + ranges;
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const bool last = t + 1 == tiles;

  // each thread a run of neighbouring ranges: their first pairs (an
  // exclusive scan of the totals) plus this tile's offsets within them,
  // and their starts in the staged order (an exclusive scan of the
  // tile's counts, the difference of two rows of offsets)
  const int per = (ranges + kThreads - 1) / kThreads;
  const int r0 = threadIdx.x * per;
  uint32_t sum = 0, mine = 0;
  for (int q = 0; q < per; ++q) {
    const int r = r0 + q;
    if (r < ranges) {
      const uint32_t o = offs[t * ranges + r];
      sum += totals[r];
      mine += (last ? totals[r] : offs[(t + 1) * ranges + r]) - o;
    }
  }
  uint32_t all;
  uint32_t run = block_exclusive_scan<kThreads>(sum, warp_sums, &all);
  uint32_t at = block_exclusive_scan<kThreads>(mine, warp_sums, &all);
  for (int q = 0; q < per; ++q) {
    const int r = r0 + q;
    if (r < ranges) {
      const uint32_t o = offs[t * ranges + r];
      if (t == 0) bases[r] = run;
      dest[r] = run + o;
      start[r] = at;
      seen[r] = 0;
      run += totals[r];
      at += (last ? totals[r] : offs[(t + 1) * ranges + r]) - o;
    }
  }
  __syncthreads();

  const int64_t begin = t * tile;
  const int64_t end = begin + tile < n ? begin + tile : n;
  const int mask = (1 << log_r) - 1;
  for (int64_t i0 = begin; i0 < end; i0 += kThreads * kItems) {
    I raw[kItems];
    V v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = i0 + k * kThreads + threadIdx.x;
      raw[k] = i < end ? idx[i] : I(0);
      if constexpr (VB != 0) v[k] = i < end ? val[i] : V(0);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = i0 + k * kThreads + threadIdx.x;
      const int j = i < end ? target_index(raw[k], N) : -1;
      if (j >= 0) {
        const uint32_t slot = start[j >> log_r] + atomicAdd(&seen[j >> log_r],
                                                            1u);
        soff[slot] = static_cast<uint16_t>(j & mask);
        if constexpr (VB != 0) sval[slot] = v[k];
      }
    }
  }
  __syncthreads();
  // the tile's runs, one warp a range
  for (int r = warp; r < ranges; r += kWarps) {
    const uint32_t cnt = seen[r], from = start[r], to = dest[r];
    for (uint32_t e = lane; e < cnt; e += 32) {
      ppos[to + e] = soff[from + e];
      if constexpr (VB != 0) pval[to + e] = sval[from + e];
    }
  }
}

// a range between the target and shared memory, 16 bytes a thread where
// the target is 16-byte aligned, then the tail element by element
template <typename T, bool IN>
__device__ __forceinline__ void copy_range(T* s, T* g, int len, bool vec16) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if (vec16) {
    const int nv = len / kPer;
    uint4* sv = reinterpret_cast<uint4*>(s);
    uint4* gv = reinterpret_cast<uint4*>(g);
    for (int q0 = 0; q0 < nv; q0 += kBuildThreads * 4) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * kBuildThreads + threadIdx.x;
        if (q < nv) r[u] = IN ? gv[q] : sv[q];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * kBuildThreads + threadIdx.x;
        if (q < nv) {
          if (IN) {
            sv[q] = r[u];
          } else {
            gv[q] = r[u];
          }
        }
      }
    }
    done = nv * kPer;
  }
  for (int e = done + threadIdx.x; e < len; e += kBuildThreads) {
    if (IN) {
      s[e] = g[e];
    } else {
      g[e] = s[e];
    }
  }
}

// a batch of a range's pairs, kBuildUnroll a thread from k0
template <typename T>
__device__ __forceinline__ void load_pairs(int* p, T* v, uint32_t k0,
                                           uint32_t cnt, uint32_t base,
                                           const uint16_t* __restrict__ ppos,
                                           const T* __restrict__ pval,
                                           T scalar) {
#pragma unroll
  for (int u = 0; u < kBuildUnroll; ++u) {
    const uint32_t k = k0 + u * kBuildThreads + threadIdx.x;
    p[u] = k < cnt ? ppos[base + k] : 0;
    v[u] = (k < cnt && pval != nullptr) ? pval[base + k] : scalar;
  }
}

// (d) one block a range: load it, apply its pairs, write it back
template <typename T, int M>
__global__ void __launch_bounds__(kBuildThreads)
    build_kernel(T* __restrict__ out, int N, int log_r,
                 const uint32_t* __restrict__ totals,
                 const uint32_t* __restrict__ bases,
                 const uint16_t* __restrict__ ppos,
                 const T* __restrict__ pval, T scalar, bool vec16) {
  extern __shared__ __align__(16) unsigned char build_smem[];
  T* s = reinterpret_cast<T*>(build_smem);
  const int r = blockIdx.x;
  const uint32_t cnt = totals[r];
  if (cnt == 0) return;
  const uint32_t base = bases[r];
  const int64_t lo = static_cast<int64_t>(r) << log_r;
  const int64_t room = static_cast<int64_t>(N) - lo;
  const int len = static_cast<int>(room < (1ll << log_r) ? room
                                                         : (1ll << log_r));
  T* g = out + lo;
  // the pairs' loads run a batch ahead: the first batch's beside the
  // range's, each next batch's beside the combines of the one before
  constexpr uint32_t kStep = kBuildThreads * kBuildUnroll;
  int p[kBuildUnroll];
  T v[kBuildUnroll];
  load_pairs<T>(p, v, 0, cnt, base, ppos, pval, scalar);
  copy_range<T, true>(s, g, len, vec16);
  __syncthreads();
  for (uint32_t k0 = 0; k0 < cnt; k0 += kStep) {
    int pn[kBuildUnroll];
    T vn[kBuildUnroll];
    if (k0 + kStep < cnt) {
      load_pairs<T>(pn, vn, k0 + kStep, cnt, base, ppos, pval, scalar);
    }
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      const uint32_t k = k0 + u * kBuildThreads + threadIdx.x;
      if (k < cnt) combine<T, M>(s + p[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      p[u] = pn[u];
      v[u] = vn[u];
    }
  }
  __syncthreads();
  copy_range<T, false>(s, g, len, vec16);
}

// ---------------------------------------------------------------------------
// Form B
// ---------------------------------------------------------------------------

// window blockIdx.y of `window` elements; the updates by grid stride over
// blockIdx.x
template <typename T, int M, typename I>
__global__ void __launch_bounds__(kPrivThreads)
    privatized_kernel(T* __restrict__ out, int N, int window,
                      const I* __restrict__ idx, const T* __restrict__ val,
                      int64_t n, T scalar) {
  extern __shared__ __align__(16) unsigned char priv_smem[];
  T* s = reinterpret_cast<T*>(priv_smem);
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * window;
  const int64_t room = static_cast<int64_t>(N) - lo;
  const int len = static_cast<int>(room < window ? room : window);
  const T id = identity<T, M>();
  for (int e = threadIdx.x; e < len; e += kPrivThreads) s[e] = id;
  __syncthreads();
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPrivThreads *
                       kPrivUnroll;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kPrivThreads *
                    kPrivUnroll;
       i0 < n; i0 += step) {
    I raw[kPrivUnroll];
    T v[kPrivUnroll];
#pragma unroll
    for (int u = 0; u < kPrivUnroll; ++u) {
      const int64_t i = i0 + u * kPrivThreads + threadIdx.x;
      raw[u] = i < n ? idx[i] : I(0);
      v[u] = (i < n && val != nullptr) ? val[i] : scalar;
    }
#pragma unroll
    for (int u = 0; u < kPrivUnroll; ++u) {
      const int64_t i = i0 + u * kPrivThreads + threadIdx.x;
      const int j = i < n ? target_index(raw[u], N) : -1;
      const int64_t e = j - lo;
      if (j >= 0 && e >= 0 && e < len) combine<T, M>(s + e, v[u]);
    }
  }
  __syncthreads();
  const BitsOf<T> none = to_bits(id);
  for (int e = threadIdx.x; e < len; e += kPrivThreads) {
    const T w = s[e];
    if (to_bits(w) != none) combine<T, M>(out + lo + e, w);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
T scalar_of(unsigned long long bits) {
  T v;
  memcpy(&v, &bits, sizeof(T));
  return v;
}

struct RangeArgs {
  void* out;
  int N;
  const void* idx;
  int64_t n;
  const void* val;
  unsigned long long scalar_bits;
  int log_r, ranges;
  int64_t tile, tiles;
  uint32_t *counts, *totals, *bases;
  uint16_t* ppos;
  void* pval;
  cudaStream_t st;
};

template <typename I, int VB>
int distribute(const RangeArgs& a) {
  static int configured[kMaxDevices] = {};
  const int smem = distribute_smem(a.ranges, a.tile, VB);
  int rc = allow_smem(reinterpret_cast<const void*>(&distribute_kernel<I, VB>),
                      smem, configured);
  if (rc != 0) return rc;
  distribute_kernel<I, VB><<<static_cast<unsigned>(a.tiles), kThreads, smem,
                             a.st>>>(
      static_cast<const I*>(a.idx), a.val, a.n, a.N, a.log_r, a.ranges,
      a.tile, a.tiles, a.counts, a.totals, a.bases, a.ppos, a.pval);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int build(const RangeArgs& a) {
  static int configured[kMaxDevices] = {};
  const int smem = static_cast<int>(sizeof(T)) << a.log_r;
  int rc = allow_smem(reinterpret_cast<const void*>(&build_kernel<T, M>),
                      smem, configured);
  if (rc != 0) return rc;
  const bool vec16 = (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  build_kernel<T, M><<<static_cast<unsigned>(a.ranges), kBuildThreads, smem,
                       a.st>>>(
      static_cast<T*>(a.out), a.N, a.log_r, a.totals, a.bases, a.ppos,
      static_cast<const T*>(a.pval), scalar_of<T>(a.scalar_bits), vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int build_mode(const RangeArgs& a, int mode) {
  switch (mode) {
    case kStore: return build<T, kStore>(a);
    case kAdd: return build<T, kAdd>(a);
    case kMin: return build<T, kMin>(a);
    case kMax: return build<T, kMax>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename I>
int ranges_run(const RangeArgs& a, int dtype, int mode) {
  count_kernel<I><<<static_cast<unsigned>(a.tiles), kThreads, a.ranges * 4,
                    a.st>>>(static_cast<const I*>(a.idx), a.n, a.N, a.log_r,
                            a.ranges, a.tile, a.counts);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rowscan_kernel<<<static_cast<unsigned>(a.ranges), kThreads, 0, a.st>>>(
      a.counts, a.tiles, a.ranges, a.totals);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int vb = a.val == nullptr ? 0 : (dtype == 1 || dtype == 3 ? 8 : 4);
  rc = vb == 0 ? distribute<I, 0>(a)
               : (vb == 4 ? distribute<I, 4>(a) : distribute<I, 8>(a));
  if (rc != 0) return rc;
  // the pairs' values, where there are any, are the distribute's output
  RangeArgs b = a;
  if (a.val == nullptr) b.pval = nullptr;
  switch (dtype) {
    case 0: return build_mode<float>(b, mode);
    case 1: return build_mode<double>(b, mode);
    case 2: return build_mode<int32_t>(b, mode);
    case 3: return build_mode<int64_t>(b, mode);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct PrivArgs {
  void* out;
  int N;
  const void* idx;
  int64_t n;
  const void* val;
  unsigned long long scalar_bits;
  int window, windows, blocks;
  cudaStream_t st;
};

template <typename T, int M, typename I>
int privatized(const PrivArgs& a) {
  static int configured[kMaxDevices] = {};
  const int smem = a.window * static_cast<int>(sizeof(T));
  int rc = allow_smem(
      reinterpret_cast<const void*>(&privatized_kernel<T, M, I>), smem,
      configured);
  if (rc != 0) return rc;
  privatized_kernel<T, M, I><<<dim3(a.blocks, a.windows), kPrivThreads, smem,
                               a.st>>>(
      static_cast<T*>(a.out), a.N, a.window, static_cast<const I*>(a.idx),
      static_cast<const T*>(a.val), a.n, scalar_of<T>(a.scalar_bits));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int privatized_mode(const PrivArgs& a, int mode) {
  switch (mode) {
    case kAdd: return privatized<T, kAdd, I>(a);
    case kMin: return privatized<T, kMin, I>(a);
    case kMax: return privatized<T, kMax, I>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename I>
int privatized_type(const PrivArgs& a, int dtype, int mode) {
  switch (dtype) {
    case 0: return privatized_mode<float, I>(a, mode);
    case 1: return privatized_mode<double, I>(a, mode);
    case 2: return privatized_mode<int32_t, I>(a, mode);
    case 3: return privatized_mode<int64_t, I>(a, mode);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Updates a round of the distribute kernel: a tile is a multiple of it.
int vex_scatter_chunk(void) { return kChunk; }

// Form A.  out: the target (N elements of dtype 0 f32, 1 f64, 2 i32,
// 3 i64); idx: n indices (i32, or i64 when idx64); val: n values of the
// target's type, or null for the scalar whose bits are scalar_bits; mode:
// 0 store, 1 add, 2 min, 3 max.  Ranges of 2^log_r elements, tiles of
// `tile` updates.  Scratch: counts (tiles x ranges u32), totals and bases
// (ranges u32 each), ppos (n u16) and, with values, pval (n values).
int vex_scatter_ranges(void* out, int dtype, int N, const void* idx,
                       int idx64, int64_t n, const void* val,
                       unsigned long long scalar_bits, int mode, int log_r,
                       int ranges, int64_t tile, int64_t tiles, void* counts,
                       void* totals, void* bases, void* ppos, void* pval,
                       void* stream) {
  if (dtype < 0 || dtype > 3 || mode < 0 || mode > 3 || log_r < 3 ||
      log_r > 16 || ranges <= 0 || tiles <= 0 || tile % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RangeArgs a{out, N, idx, n, val, scalar_bits, log_r, ranges, tile, tiles,
              static_cast<uint32_t*>(counts), static_cast<uint32_t*>(totals),
              static_cast<uint32_t*>(bases), static_cast<uint16_t*>(ppos),
              pval, static_cast<cudaStream_t>(stream)};
  return idx64 ? ranges_run<int64_t>(a, dtype, mode)
               : ranges_run<int32_t>(a, dtype, mode);
}

// Form B: modes 1 add, 2 min, 3 max; windows of `window` elements (grid
// blocks x windows).
int vex_scatter_privatized(void* out, int dtype, int N, const void* idx,
                           int idx64, int64_t n, const void* val,
                           unsigned long long scalar_bits, int mode,
                           int window, int windows, int blocks,
                           void* stream) {
  if (dtype < 0 || dtype > 3 || mode < 1 || mode > 3 || window <= 0 ||
      windows <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PrivArgs a{out, N, idx, n, val, scalar_bits, window, windows, blocks,
             static_cast<cudaStream_t>(stream)};
  return idx64 ? privatized_type<int64_t>(a, dtype, mode)
               : privatized_type<int32_t>(a, dtype, mode);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
