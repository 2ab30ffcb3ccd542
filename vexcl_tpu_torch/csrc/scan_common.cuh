// The pieces that the single-pass look-back scans share: csrc/scan.cu
// (scan, segscan) and csrc/by_key.cu (reduce_by_key, the keyed scans).
//
// A block of kThreads threads takes a tile of kTile<A> elements of the
// carry type A (kItems<A> a thread, in order); tiles are grouped in
// windows of kWindow, and tile t's exclusive prefix is P(b - 1) . F, F the
// block-wide fold of the window's aggregates before t (scan.cu, rules 1-6,
// gives the design).  Here: the monoids and their NaN and wrap rules, the
// (head flag, value) combine, the block-wide scans, the status words
// (st.release / ld.acquire, an 8-byte carry in its own slot) and the
// look-back over a window.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = kThreads;          // words a look-back reads: one a thread
constexpr unsigned kFull = 0xffffffffu;

// a status word: 0 (nothing published), or ready, the head flag and, for
// a 4-byte carry, its bits
constexpr unsigned long long kReady = 1ull << 63;
constexpr unsigned long long kHead = 1ull << 62;

enum Mono : int { kAdd = 0, kMax = 1, kMin = 2 };

// The type a scan carries: bf16 values are loaded and carried in f32 and
// stored as bf16, as the Pallas kernels do.
template <typename T>
struct Carry {
  using type = T;
};
template <>
struct Carry<__nv_bfloat16> {
  using type = float;
};

// A thread scans 128 bytes of carry in order: 32 elements of a 4-byte
// carry, 16 of an 8-byte one; a tile is kThreads of those runs.
template <typename A>
constexpr int kItems = 128 / sizeof(A);
template <typename A>
constexpr int kTile = kThreads * kItems<A>;

// blocks an SM the launch bound asks room for: at most 64 registers a
// thread, for every carry type
constexpr int kMinBlocks = 4;

// Shared-memory index of tile element i, padded so that a thread's run of
// kItems elements and a warp's 16-byte vectors fall in distinct banks: one
// word in 32 for a 4-byte carry, in 16 for an 8-byte one.
template <typename A>
constexpr int kPadShift = sizeof(A) == 8 ? 4 : 5;
template <typename A>
__device__ __forceinline__ int pad(int i) {
  return i + (i >> kPadShift<A>);
}

template <typename A, typename T>
__device__ __forceinline__ A load_as(T v) {
  return static_cast<A>(v);
}
template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T, typename A>
__device__ __forceinline__ T store_as(A v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename A>
struct Limits;
template <>
struct Limits<float> {
  static __device__ __forceinline__ float lowest() { return -__int_as_float(0x7f800000); }
  static __device__ __forceinline__ float highest() { return __int_as_float(0x7f800000); }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double lowest() {
    return -__longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double highest() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};
template <>
struct Limits<int32_t> {
  static __device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t highest() { return INT32_MAX; }
};
template <>
struct Limits<int64_t> {
  static __device__ __forceinline__ int64_t lowest() { return INT64_MIN; }
  static __device__ __forceinline__ int64_t highest() { return INT64_MAX; }
};

template <typename A>
__device__ __forceinline__ bool is_nan(A a) {
  return a != a;  // constant false for integers
}

template <typename A>
__device__ __forceinline__ A wrap_add(A a, A b) {
  return a + b;
}
template <>
__device__ __forceinline__ int32_t wrap_add<int32_t>(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
template <>
__device__ __forceinline__ int64_t wrap_add<int64_t>(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

// Op<M, A>::f(a, b) with a the earlier operand.
template <int M, typename A>
struct Op;
template <typename A>
struct Op<kAdd, A> {
  static __device__ __forceinline__ A ident() { return A(0); }
  static __device__ __forceinline__ A f(A a, A b) { return wrap_add(a, b); }
};
template <typename A>
struct Op<kMax, A> {
  static __device__ __forceinline__ A ident() { return Limits<A>::lowest(); }
  static __device__ __forceinline__ A f(A a, A b) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
  }
};
template <typename A>
struct Op<kMin, A> {
  static __device__ __forceinline__ A ident() { return Limits<A>::highest(); }
  static __device__ __forceinline__ A f(A a, A b) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
  }
};

// (v, f) := (pv, pf) . (v, f), the earlier pair (pv, pf) on the left.
template <int M, typename A, bool SEG>
__device__ __forceinline__ void combine(A& v, bool& f, A pv, bool pf) {
  if (SEG) {
    if (!f) v = Op<M, A>::f(pv, v);
    f = f || pf;
  } else {
    v = Op<M, A>::f(pv, v);
  }
}

template <typename A>
__device__ __forceinline__ A shfl_up(A v, int d) {
  static_assert(sizeof(A) == 4 || sizeof(A) == 8, "4- or 8-byte carry");
  if constexpr (sizeof(A) == 8) {
    long long b;
    memcpy(&b, &v, 8);
    b = __shfl_up_sync(kFull, b, d);
    memcpy(&v, &b, 8);
  } else {
    int b;
    memcpy(&b, &v, 4);
    b = __shfl_up_sync(kFull, b, d);
    memcpy(&v, &b, 4);
  }
  return v;
}

// Block-wide scans of one (value, flag) pair per thread, in thread order.
template <int M, typename A, bool SEG>
struct BlockScan {
  struct Storage {
    A v[kWarps];
    bool f[kWarps];
    A total_v;
    bool total_f;
  };

  // (v, f) := the combination of this warp's pairs up to this lane
  static __device__ __forceinline__ void warp_inclusive(A& v, bool& f) {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
      const A ov = shfl_up(v, d);
      const bool of = __shfl_up_sync(kFull, static_cast<int>(f), d) != 0;
      if (lane >= d) combine<M, A, SEG>(v, f, ov, of);
    }
  }

  // In: the thread's aggregate (v, f).  Out: (v, f) = the combination of
  // every earlier thread's aggregate (the identity for thread 0), and
  // (tv, tf) = the combination of all of them.  Every thread must call.
  static __device__ __forceinline__ void exclusive(A& v, bool& f, A& tv, bool& tf,
                                                   Storage& s) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    A iv = v;
    bool ifl = f;
    warp_inclusive(iv, ifl);
    if (lane == 31) {
      s.v[warp] = iv;
      s.f[warp] = ifl;
    }
    A ev = shfl_up(iv, 1);
    bool ef = __shfl_up_sync(kFull, static_cast<int>(ifl), 1) != 0;
    if (lane == 0) {
      ev = Op<M, A>::ident();
      ef = false;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      A run = Op<M, A>::ident();
      bool rf = false;
      for (int w = 0; w < kWarps; ++w) {
        A wv = s.v[w];
        bool wf = s.f[w];
        s.v[w] = run;
        s.f[w] = rf;
        combine<M, A, SEG>(wv, wf, run, rf);
        run = wv;
        rf = wf;
      }
      s.total_v = run;
      s.total_f = rf;
    }
    __syncthreads();
    if (warp > 0) combine<M, A, SEG>(ev, ef, s.v[warp], s.f[warp]);
    v = ev;
    f = ef;
    tv = s.total_v;
    tf = s.total_f;
    __syncthreads();  // the storage may be reused from here on
  }

  // (v, f) := the combination of every thread's pair, for every thread.
  static __device__ __forceinline__ void total(A& v, bool& f, Storage& s) {
    const int warp = threadIdx.x >> 5;
    warp_inclusive(v, f);
    if ((threadIdx.x & 31) == 31) {
      s.v[warp] = v;
      s.f[warp] = f;
    }
    __syncthreads();
    v = s.v[0];
    f = s.f[0];
    for (int w = 1; w < kWarps; ++w) {
      A wv = s.v[w];
      bool wf = s.f[w];
      combine<M, A, SEG>(wv, wf, v, f);
      v = wv;
      f = wf;
    }
    __syncthreads();  // the storage may be reused from here on
  }
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Publish (v, f) as tile i's word.  An 8-byte carry goes to its own array
// first; the release orders that store before the word.
template <typename A>
__device__ __forceinline__ void publish(unsigned long long* status, A* values,
                                        int64_t i, A v, bool f) {
  unsigned long long w = kReady | (f ? kHead : 0ull);
  if constexpr (sizeof(A) == 8) {
    values[i] = v;
  } else {
    uint32_t b;
    memcpy(&b, &v, 4);
    w |= b;
  }
  store_release(status + i, w);
}

// The carry of tile i's word w, read after w was acquired ready.
template <typename A>
__device__ __forceinline__ A word_value(unsigned long long w, const A* values,
                                        int64_t i) {
  A v;
  if constexpr (sizeof(A) == 8) {
    const unsigned long long b =
        __ldcg(reinterpret_cast<const unsigned long long*>(values + i));
    memcpy(&v, &b, 8);
  } else {
    const auto b = static_cast<uint32_t>(w);
    memcpy(&v, &b, 4);
  }
  return v;
}

// The exclusive prefix (pv, pf) of tile t > 0, for every thread:
// P(b - 1) . F, b = t - t % kWindow, where F is the block-wide fold, in
// thread order, of AGG(b) ... AGG(t - 1) (thread i holds AGG(b + i); the
// identity above), and P(b - 1) the identity when b = 0.  The block waits
// for the aggregates together (a round trip reads the words still
// missing); then thread 0 alone waits for P(b - 1), so a link of the
// window chain costs one combine after P(b - 1) lands.  Segmented, P(b - 1)
// is not waited for when F holds a head: P(b - 1) . F is then F.
template <int M, typename A, bool SEG>
__device__ __forceinline__ void look_back(const unsigned long long* status,
                                          const A* values, int64_t t, A& pv,
                                          bool& pf,
                                          typename BlockScan<M, A, SEG>::Storage& s) {
  const int64_t b = t - t % kWindow;
  pv = Op<M, A>::ident();
  pf = false;
  if (t > b) {
    const int64_t at = b + threadIdx.x;
    const bool need = at < t;
    unsigned long long w = need ? load_acquire(status + at) : 0ull;
    while (__syncthreads_or(need && (w & kReady) == 0)) {
      if (need && (w & kReady) == 0) {   // not published yet: read it again
        __nanosleep(32);
        w = load_acquire(status + at);
      }
    }
    if (need) {
      pv = word_value(w, values, at);
      pf = SEG && (w & kHead) != 0;
    }
    BlockScan<M, A, SEG>::total(pv, pf, s);
  }
  if (threadIdx.x == 0) {
    if (b > 0 && !pf) {
      unsigned long long w;
      while (((w = load_acquire(status + b - 1)) & kReady) == 0) __nanosleep(32);
      if (t > b) {
        combine<M, A, SEG>(pv, pf, word_value(w, values, b - 1),
                           SEG && (w & kHead) != 0);
      } else {
        pv = word_value(w, values, b - 1);
        pf = SEG && (w & kHead) != 0;
      }
    }
    s.total_v = pv;
    s.total_f = pf;
  }
  __syncthreads();
  pv = s.total_v;
  pf = s.total_f;
}


}  // namespace
