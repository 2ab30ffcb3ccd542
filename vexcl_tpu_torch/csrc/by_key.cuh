// Keyed reduction and keyed scans for Hopper: one launch a call, the head
// flags computed from the keys inside the kernel.
//
// Replaces the Pallas kernel of vexcl_tpu/ops/pallas_rbk.py (_fused_kernel,
// called through pallas_segscan_rowcompact: a segmented scan and a per-row
// compaction in one pass) for reduce_by_key, and, for
// inclusive_scan_by_key and exclusive_scan_by_key, the head-flag pre-pass,
// pallas_segscan.py's _seg_kernel and the exclusive/init epilogue of
// vexcl_tpu/ops/scan_by_key.py:62-125.  The TPU kernel runs its grid in
// order and carries the running total and the output row through SMEM;
// here one launch is a single pass with decoupled look-back (Merrill and
// Garland 2016; CUB's single-pass ReduceByKey), under the rules of
// csrc/scan.cu (the atomic tile ticket; 16-byte loads into shared memory,
// unaligned starts included; windows whose bracketing does not depend on
// timing; release/acquire status words; the last block resets the
// scratch), so that the same input gives the same bits, and bits equal to
// csrc/scan.cu's segscan on the same head flags.  What is new, per tile:
//
//   a. the head bits: element e starts a run where e = 0 or a key vector
//      differs between e - 1 and e.  The key vectors (1 to kMaxKeys, each
//      of 1, 2, 4 or 8 bytes, any alignment) are read coalesced, 16 bytes a
//      thread a round, a batch of rounds in flight; an element's left
//      neighbour is the one before it in the thread's 16 bytes, the previous
//      lane's last (a shuffle), or, for lane 0, one load of it, which also
//      reaches across the tile's start.  The differences are or-ed into a
//      bit mask of the tile in shared memory.  Integer and bool keys
//      compare as bits; float keys (f16, bf16, f32, f64, and complex ones
//      lane by lane) as values: a NaN differs from everything, -0.0 equals
//      +0.0, as `k[:-1] == k[1:]` does.  The key's type is a run-time code
//      read in a loop over the key vectors, not a template parameter;
//   b. reduce_by_key: element e ends a run where e + 1 starts one or e =
//      n - 1, so the mask also holds the element after the tile.  The
//      look-back carries the triple (head seen, open-run value, runs ended
//      before): (f1, v1, c1) . (f2, v2, c2) = (f1 | f2, f2 ? v2 : op(v1,
//      v2), c1 + c2).  The count is a plain sum, so unlike segscan every
//      tile waits for P(b - 1) (the window chain: tiles / kWindow links, 8
//      at 2^24 f32).  A tile's count is published the way an 8-byte carry
//      is: in its own slot, stored before the word's st.release and read
//      after its ld.acquire (in the word beside a 4-byte carry it moved
//      nothing: PERF.md);
//   c. a run's total is written by the tile that holds its tail, to slot
//      (runs ended before the tile) + (rank among the tile's tails): the
//      tails' places are listed in shared memory in order and the totals,
//      read from the rescanned tile, stored as one contiguous stretch, as
//      csrc/compact.cu does; each key vector's key at the tail is copied to
//      the same slot (the tail's key, as the JAX package writes it: -0.0
//      and +0.0 in one run report the last).  A tile with no tail writes
//      nothing.  The tile that holds element n - 1 writes the run count;
//   d. the keyed scans: the same front end and segscan's look-back; the
//      mode puts op(init, incl) at every element (inclusive with init), or
//      init (a literal 0 without one, for max and min too) at each head and
//      op(init, incl[i - 1]) elsewhere (exclusive).  The rescan leaves
//      incl in shared memory, and incl[i - 1] at a thread's first element
//      is the thread before's last; at the tile's first element (not a
//      head) it is the tile before's last, which each tile publishes in
//      its status word (kLast) before it waits for its predecessor's: one
//      hop, no chain.  So the bits are segscan's incl and the tensor
//      epilogue's, where the tile's incoming prefix, bracketed otherwise,
//      would differ in a float sum's last bits.  A bf16 incl is rounded to
//      bf16 before init is folded in, as the epilogue does.  y may be x.
//
// Bound on this card: keys and values read once, the outputs written once.
// reduce_by_key of 2^24 f32 values and i32 keys in runs of 64: 134 MB in,
// 2 MB out, 40.7 us at 3.35 TB/s; the keyed scan 201 MB, 60.1 us.  What
// holds it above that is scan.cu's: the life of a tile (its ticket, the
// loads of x and then of the keys, the waits of the look-back, the
// stores) keeps its SM slot; reduce_by_key adds the wait on the chain.
//
// Scratch, cached by the wrapper per (device, stream): per tile a status
// word and three 8-byte slots (an 8-byte carry, the count, the last
// inclusive value), and two counters; the words and counters are 0
// between launches.
//
// The kernel is instantiated by three libraries, one a carry width, each a
// source of its own so that their builds run at once: by_key.cu (f32,
// i32), by_key_wide.cu (f64, i64) and by_key_bf16.cu (bf16); their plain C
// interface for ctypes (vex_by_key, below) launches on the given stream
// and returns the CUDA error of the launch (0 when it was accepted).

#pragma once

#include "scan_common.cuh"

namespace {

constexpr int kMaxKeys = 7;
constexpr int kKeyBatch = 4;     // 16-byte key loads a thread keeps in flight

enum Mode : int {
  kInclusive = 0,
  kInclusiveInit = 1,
  kExclusive = 2,
  kExclusiveInit = 3,
  kReduce = 4,
};

// key type codes (ops/cuda_by_key.py _KEY_KIND)
enum KeyKind : int { kInt = 0, kF16 = 1, kBF16 = 2, kF32 = 3, kF64 = 4 };

// A key vector: its 16-byte aligned base, the elements from there to
// key[0], the log2 of its width, and for float keys the bytes of a float
// lane (0 for integer keys) and a lane's +inf bits.
struct KeyVec {
  const void* base;
  int shift;
  int log2w;
  int lane;
  unsigned long long inf;
};

struct Keys {
  KeyVec k[kMaxKeys];
  void* out[kMaxKeys];            // reduce: each key vector's tail keys
  int count;
};

template <int W>
struct Word;
template <>
struct Word<1> {
  using type = uint8_t;
};
template <>
struct Word<2> {
  using type = uint16_t;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<8> {
  using type = unsigned long long;
};

// One float lane of L bytes of two keys equal as values: equal bits that
// are not NaN, or both zero up to the sign (-0.0 == +0.0).
template <int L>
__device__ __forceinline__ bool lane_equal(unsigned long long x,
                                           unsigned long long y,
                                           unsigned long long inf) {
  constexpr unsigned long long mag = L == 8 ? ~0ull >> 1 : (1ull << (8 * L - 1)) - 1;
  return x == y ? (x & mag) <= inf : ((x | y) & mag) == 0;
}

// a and b (the bits of one W-byte key) equal: as bits (lane 0), as one
// float lane of W bytes, or as two of W / 2 (complex keys).
template <int W>
__device__ __forceinline__ bool keys_equal(unsigned long long a,
                                           unsigned long long b, int lane,
                                           unsigned long long inf) {
  if constexpr (W == 1) {
    return a == b;
  } else {
    if (lane == 0) return a == b;
    if (lane == W) return lane_equal<W>(a, b, inf);
    if constexpr (W >= 4) {
      constexpr unsigned long long half = (1ull << (4 * W)) - 1;
      return lane_equal<W / 2>(a & half, b & half, inf) &&
             lane_equal<W / 2>(a >> (4 * W), b >> (4 * W), inf);
    }
    return a == b;
  }
}

// the low k bits (k clamped to 0 .. 32)
__device__ __forceinline__ unsigned low32(int64_t k) {
  return k >= 32 ? 0xffffffffu : (k <= 0 ? 0u : (1u << k) - 1u);
}

__device__ __forceinline__ void or_bits(unsigned* bits, int64_t i,
                                        unsigned long long m) {
  const int word = static_cast<int>(i >> 5);
  m <<= (i & 31);
  atomicOr(&bits[word], static_cast<unsigned>(m));
  if ((m >> 32) != 0) atomicOr(&bits[word + 1], static_cast<unsigned>(m >> 32));
}

// Key p (from the aligned base) of a key vector of 1 << log2w bytes, as bits.
__device__ __forceinline__ unsigned long long key_bits(const void* base,
                                                       int log2w, int64_t p) {
  switch (log2w) {
    case 0: return static_cast<const uint8_t*>(base)[p];
    case 1: return static_cast<const uint16_t*>(base)[p];
    case 2: return static_cast<const uint32_t*>(base)[p];
    default: return static_cast<const unsigned long long*>(base)[p];
  }
}

// OR into bits (bit i: tile position i, element e_lo + i) a 1 for every
// element e in [max(e_lo, 1), e_end] that differs from element e - 1 in
// this key vector of W-byte keys.  Every thread of the block calls it
// (shuffles): rounds of kThreads 16-byte vectors, kKeyBatch rounds loaded
// at once; an element's left neighbour is the element before it in the
// vector, the previous lane's last, or for lane 0 one load of it.
template <int W, int KT>
__device__ __noinline__ void key_heads(const void* vbase, int kshift,
                                       int lane_bytes, unsigned long long inf,
                                       int64_t e_lo, int64_t e_end,
                                       unsigned* bits) {
  using U = typename Word<W>::type;
  constexpr int V = 16 / W;
  constexpr int kRounds = KT / V / kThreads;
  constexpr int kBatch = kRounds < kKeyBatch ? kRounds : kKeyBatch;
  const int64_t e_first = e_lo > 1 ? e_lo : 1;
  if (e_first > e_end) return;
  const U* base = static_cast<const U*>(vbase);
  const int64_t v_first = (e_first + kshift) / V;
  const int64_t v_last = (e_end + kshift) / V;
  const int lane = threadIdx.x & 31;
  for (int64_t r0 = 0; v_first + r0 * kThreads <= v_last; r0 += kBatch) {
    uint4 w[kBatch];
    U left[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int64_t v = v_first + (r0 + r) * kThreads + threadIdx.x;
      const int64_t e0 = v * V - kshift;
      const bool active = v <= v_last;
      w[r] = active ? __ldg(reinterpret_cast<const uint4*>(base) + v)
                    : make_uint4(0, 0, 0, 0);
      left[r] = lane == 0 && active && e0 >= e_first && e0 <= e_end
                    ? base[v * V - 1]
                    : U(0);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int64_t v = v_first + (r0 + r) * kThreads + threadIdx.x;
      const int64_t e0 = v * V - kshift;     // the element of e[0]
      U e[V];
      memcpy(e, &w[r], 16);
      const U up = static_cast<U>(__shfl_up_sync(
          kFull, static_cast<unsigned long long>(e[V - 1]), 1));
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const U prev = j > 0 ? e[j - 1] : (lane == 0 ? left[r] : up);
        if (e0 + j >= e_first && e0 + j <= e_end &&
            !keys_equal<W>(e[j], prev, lane_bytes, inf)) {
          m |= 1u << j;
        }
      }
      if (v <= v_last && m != 0) {
        int64_t i = e0 - e_lo;                // tile position of e[0]
        unsigned long long mm = m;
        if (i < 0) {                          // bits below e_first are 0
          mm >>= -i;
          i = 0;
        }
        or_bits(bits, i, mm);
      }
    }
  }
}

// Element e of a key vector differs from element e - 1 (e >= 1).
__device__ __forceinline__ bool key_differs(const KeyVec& kv, int64_t e) {
  const int64_t p = e + kv.shift;
  const unsigned long long a = key_bits(kv.base, kv.log2w, p);
  const unsigned long long b = key_bits(kv.base, kv.log2w, p - 1);
  switch (kv.log2w) {
    case 0: return !keys_equal<1>(a, b, kv.lane, kv.inf);
    case 1: return !keys_equal<2>(a, b, kv.lane, kv.inf);
    case 2: return !keys_equal<4>(a, b, kv.lane, kv.inf);
    default: return !keys_equal<8>(a, b, kv.lane, kv.inf);
  }
}

// dst[j] = the key of element e_lo + idx[j], j = threadIdx.x, + kThreads,
// ... < count: neighbouring threads store neighbouring slots.
template <typename U>
__device__ __forceinline__ void copy_keys(const KeyVec& kv, void* out,
                                          int64_t e_lo, int64_t slot,
                                          const uint16_t* idx, int count) {
  const U* src = static_cast<const U*>(kv.base) + kv.shift + e_lo;
  U* dst = static_cast<U*>(out) + slot;
  for (int j = threadIdx.x; j < count; j += kThreads) dst[j] = src[idx[j]];
}

// The sum of v over the block, for every thread; s: kWarps long longs.
__device__ __forceinline__ long long block_sum(long long v, long long* s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) sum += s[k];
  __syncthreads();
  return sum;
}

// c's exclusive prefix over the threads (before) and its sum (total).
__device__ __forceinline__ void block_count(int c, int& before, int& total,
                                            long long* s) {
  const int lane = threadIdx.x & 31;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s[threadIdx.x >> 5] = incl;
  __syncthreads();
  before = incl - c;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int w = static_cast<int>(s[k]);
    if (k < (threadIdx.x >> 5)) before += w;
    total += w;
  }
  __syncthreads();
}

// A status word's bit, set once the tile's last inclusive value (the
// exclusive scans' incl[t0 - 1] of the next tile) is in its slot.
constexpr unsigned long long kLast = 1ull << 61;

__device__ __forceinline__ void red_or_release(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("red.release.gpu.global.or.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Tile i's last inclusive value into its slot, then kLast into its word.
template <typename A>
__device__ __forceinline__ void publish_last(unsigned long long* status,
                                             unsigned long long* lasts,
                                             int64_t i, A v) {
  unsigned long long b = 0;
  memcpy(&b, &v, sizeof(A));
  lasts[i] = b;
  red_or_release(status + i, kLast);
}

template <typename A>
__device__ __forceinline__ A wait_last(const unsigned long long* status,
                                       const unsigned long long* lasts,
                                       int64_t i) {
  while ((load_acquire(status + i) & kLast) == 0) __nanosleep(32);
  const unsigned long long b = __ldcg(lasts + i);
  A v;
  memcpy(&v, &b, sizeof(A));
  return v;
}

// The done ticket (thread 0): the last block to draw it resets the scratch.
__device__ __forceinline__ void draw_done(unsigned* counters, int64_t tiles,
                                          bool* s_last) {
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = atomicAdd(&counters[1], 1u) == static_cast<unsigned>(tiles - 1);
  }
}

// The exclusive prefix (pv, pf, pc) of tile t > 0 in reduce_by_key, for
// every thread: P(b - 1) . F with counts, as look_back (scan_common.cuh)
// forms (pv, pf), except that P(b - 1) is always waited for, its count
// being needed.  One round trip reads the window's words still missing and
// then their slots; thread 0's link of the chain: P(b - 1)'s word, then
// its slots.
template <int M, typename A>
__device__ __forceinline__ void look_back_counted(
    const unsigned long long* status, const A* values,
    const long long* counts, int64_t t, A& pv, bool& pf, long long& pc,
    typename BlockScan<M, A, true>::Storage& s, long long* s_sum,
    long long* s_pc) {
  const int64_t b = t - t % kWindow;
  pv = Op<M, A>::ident();
  pf = false;
  pc = 0;
  if (t > b) {
    const int64_t at = b + threadIdx.x;
    const bool need = at < t;
    unsigned long long w = need ? load_acquire(status + at) : 0ull;
    while (__syncthreads_or(need && (w & kReady) == 0)) {
      if (need && (w & kReady) == 0) {
        __nanosleep(32);
        w = load_acquire(status + at);
      }
    }
    long long c = 0;
    if (need) {
      pv = word_value(w, values, at);
      pf = (w & kHead) != 0;
      c = __ldcg(counts + at);
    }
    BlockScan<M, A, true>::total(pv, pf, s);
    pc = block_sum(c, s_sum);
  }
  if (threadIdx.x == 0) {
    if (b > 0) {
      unsigned long long w;
      while (((w = load_acquire(status + b - 1)) & kReady) == 0) __nanosleep(32);
      const A wv = word_value(w, values, b - 1);
      const bool wf = (w & kHead) != 0;
      if (t > b) {
        combine<M, A, true>(pv, pf, wv, wf);
      } else {
        pv = wv;
        pf = wf;
      }
      pc += __ldcg(counts + b - 1);
    }
    s.total_v = pv;
    s.total_f = pf;
    *s_pc = pc;
  }
  __syncthreads();
  pv = s.total_v;
  pf = s.total_f;
  pc = *s_pc;
}

// A element i rounded through T (bf16 carried in f32: the stored value)
template <typename T, typename A>
__device__ __forceinline__ A as_stored(A v) {
  return load_as<A>(store_as<T>(v));
}

// x = xb + shift (elements), xb 16-byte aligned; a tile covers positions
// [tile * kTile, (tile + 1) * kTile) from xb, elements e_lo = position -
// shift.  Scans: y = yb + shift, yb 16-byte aligned when yvec; x and y may
// be the same array (not __restrict__).  Reduce: yb is the run totals'
// output, count the run count's.  Dynamic shared memory: the tile's
// values, its bit mask, and for reduce its tails' places.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    by_key_kernel(const T* xb, T* yb, bool yvec, int shift, int64_t n,
                  int64_t tiles, Keys keys, int mode,
                  typename Carry<T>::type init, int64_t* count,
                  unsigned long long* status, typename Carry<T>::type* values,
                  long long* counts, unsigned long long* lasts,
                  unsigned* counters) {
  using A = typename Carry<T>::type;
  using Scan = BlockScan<M, A, true>;
  constexpr int kIt = kItems<A>;
  constexpr int kT = kTile<A>;
  constexpr int V = 16 / sizeof(T);
  constexpr int kLoads = kIt / V;
  constexpr int kVals = kT + (kT >> kPadShift<A>);
  constexpr int kBitWords = kT / 32 + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  A* s_v = reinterpret_cast<A*>(smem);
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_v + kVals);
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_bits + kBitWords);
  __shared__ typename Scan::Storage s_scan;
  __shared__ long long s_sum[kWarps];
  __shared__ long long s_pc;
  __shared__ int64_t s_tile;
  __shared__ bool s_last;
  const bool reduce = mode == kReduce;

  int64_t tile = 0;
  if (tiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&counters[0], 1u);
    __syncthreads();
    tile = s_tile;
  }
  const int64_t t0 = tile * kT;
  const int64_t vend = n + shift;
  const int64_t e_lo = t0 - shift;

  // the tile's values, all in flight at once, then into shared memory
  uint4 chunk[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t v = t0 + static_cast<int64_t>(k * kThreads + threadIdx.x) * V;
    chunk[k] = v < vend ? __ldcs(reinterpret_cast<const uint4*>(xb + v))
                        : make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < kBitWords; i += kThreads) s_bits[i] = 0;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int q = (k * kThreads + threadIdx.x) * V;
    T e[V];
    memcpy(e, &chunk[k], 16);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int64_t g = t0 + q + j;
      s_v[pad<A>(q + j)] = g >= shift && g < vend ? load_as<A>(e[j])
                                                  : Op<M, A>::ident();
    }
  }
  __syncthreads();

  // the head bits of positions 0 .. kT - 1, and for reduce of position kT
  // (the element after the tile), from every key vector
  const int64_t e_end = (e_lo + kT - 1 < n - 1 ? e_lo + kT - 1 : n - 1);
  for (int k = 0; k < keys.count; ++k) {
    const KeyVec& kv = keys.k[k];
    switch (kv.log2w) {
      case 0: key_heads<1, kT>(kv.base, kv.shift, kv.lane, kv.inf, e_lo, e_end, s_bits); break;
      case 1: key_heads<2, kT>(kv.base, kv.shift, kv.lane, kv.inf, e_lo, e_end, s_bits); break;
      case 2: key_heads<4, kT>(kv.base, kv.shift, kv.lane, kv.inf, e_lo, e_end, s_bits); break;
      default: key_heads<8, kT>(kv.base, kv.shift, kv.lane, kv.inf, e_lo, e_end, s_bits);
    }
  }
  if (threadIdx.x == 0) {
    if (e_lo <= 0) or_bits(s_bits, -e_lo, 1);          // element 0
    if (reduce) {
      const int64_t after = e_lo + kT;                  // its first element
      if (n - e_lo <= kT) {
        or_bits(s_bits, n - e_lo, 1);                   // n - 1 ends a run
      } else {
        bool neq = false;
        for (int k = 0; k < keys.count; ++k) neq = neq || key_differs(keys.k[k], after);
        if (neq) or_bits(s_bits, kT, 1);
      }
    }
  }
  __syncthreads();

  // this thread's head and tail bits, elements outside [0, n) masked
  const int i0 = threadIdx.x * kIt;        // this thread's first position
  unsigned hb, tb;
  {
    const unsigned long long win =
        s_bits[i0 >> 5] |
        (static_cast<unsigned long long>(s_bits[(i0 >> 5) + 1]) << 32);
    const int off = i0 & 31;
    const unsigned valid = low32(kIt) & low32(n - e_lo - i0) & ~low32(-e_lo - i0);
    hb = static_cast<unsigned>(win >> off) & valid;
    tb = static_cast<unsigned>(win >> (off + 1)) & valid;
  }

  // this thread's aggregate, then its prefix in the tile and the tile's
  A v = s_v[pad<A>(i0)];
  bool f = (hb & 1u) != 0;
#pragma unroll
  for (int j = 1; j < kIt; ++j) {
    const A e = s_v[pad<A>(i0 + j)];
    if (((hb >> j) & 1u) != 0) {
      v = e;
      f = true;
    } else {
      v = Op<M, A>::f(v, e);
    }
  }
  A tv;
  bool tf;
  Scan::exclusive(v, f, tv, tf, s_scan);
  int cbefore = 0, ctot = 0;
  if (reduce) block_count(__popc(tb), cbefore, ctot, s_sum);

  long long pc = 0;                        // runs ended before the tile
  const bool excl = mode == kExclusive || mode == kExclusiveInit;
  if (tiles > 1) {
    const bool ends_window = tile % kWindow == kWindow - 1;
    const bool read_later = tile < tiles - 1;
    if (threadIdx.x == 0 && !ends_window && read_later) {
      if (reduce) counts[tile] = ctot;
      publish(status, values, tile, tv, tf);
    }
    if (tile > 0) {
      A pv;
      bool pf;
      if (reduce) {
        look_back_counted<M, A>(status, values, counts, tile, pv, pf, pc,
                                s_scan, s_sum, &s_pc);
      } else {
        look_back<M, A, true>(status, values, tile, pv, pf, s_scan);
      }
      if (threadIdx.x == 0 && ends_window && read_later) {
        combine<M, A, true>(tv, tf, pv, pf);
        if (reduce) counts[tile] = pc + ctot;
        publish(status, values, tile, tv, tf);
      }
      combine<M, A, true>(v, f, pv, pf);
    }
    // done with the scratch: draw the done ticket now, so that its round
    // trip overlaps the rescan (exclusive: after the last-value exchange)
    if (!excl) draw_done(counters, tiles, &s_last);
  }
  if (reduce && tile == tiles - 1 && threadIdx.x == 0) *count = pc + ctot;

  // v is the combination of everything before this thread's elements:
  // the rescan leaves each element's inclusive value in s_v
  A run = v;
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int p = pad<A>(i0 + j);
    run = ((hb >> j) & 1u) != 0 ? s_v[p] : Op<M, A>::f(run, s_v[p]);
    s_v[p] = run;
  }
  if (reduce) {                            // the tails' places, in order
    int k = cbefore;
    for (unsigned m = tb; m != 0; m &= m - 1) {
      s_idx[k++] = static_cast<uint16_t>(i0 + __ffs(m) - 1);
    }
  }
  __syncthreads();

  // exclusive: incl[i0 - 1], the last inclusive value of the thread before
  // or, at the tile's first position, of the tile before (its rescan's, so
  // that the bits are those of segscan's incl; each tile publishes its own
  // before it waits for its predecessor's, so the wait is one hop)
  A left = v;
  if (excl) {
    if (threadIdx.x > 0) left = s_v[pad<A>(i0 - 1)];
    if (tiles > 1) {
      if (threadIdx.x == kThreads - 1 && tile < tiles - 1) {
        publish_last(status, lasts, tile, run);
      }
      if (threadIdx.x == 0 && tile > 0 && (hb & 1u) == 0) {
        left = wait_last<A>(status, lasts, tile - 1);
      }
      draw_done(counters, tiles, &s_last);
    }
    __syncthreads();                       // every left read before a write
  }
  if (mode != kInclusive && !reduce) {
    // the mode's outputs in place, the last element first (exclusive reads
    // the element before)
#pragma unroll 4
    for (int j = kIt - 1; j >= 0; --j) {
      const int p = pad<A>(i0 + j);
      const bool head = ((hb >> j) & 1u) != 0;
      if (mode == kInclusiveInit) {
        s_v[p] = Op<M, A>::f(init, as_stored<T>(s_v[p]));
      } else {
        const A prev = j > 0 ? s_v[pad<A>(i0 + j - 1)] : left;
        s_v[p] = head ? (mode == kExclusiveInit ? init : A(0))
                      : (mode == kExclusiveInit
                             ? Op<M, A>::f(init, as_stored<T>(prev))
                             : prev);
      }
    }
    __syncthreads();
  }

  if (reduce) {
    for (int j = threadIdx.x; j < ctot; j += kThreads) {
      yb[pc + j] = store_as<T>(s_v[pad<A>(s_idx[j])]);
    }
    for (int k = 0; k < keys.count; ++k) {
      const KeyVec& kv = keys.k[k];
      switch (kv.log2w) {
        case 0: copy_keys<uint8_t>(kv, keys.out[k], e_lo, pc, s_idx, ctot); break;
        case 1: copy_keys<uint16_t>(kv, keys.out[k], e_lo, pc, s_idx, ctot); break;
        case 2: copy_keys<uint32_t>(kv, keys.out[k], e_lo, pc, s_idx, ctot); break;
        default: copy_keys<unsigned long long>(kv, keys.out[k], e_lo, pc, s_idx, ctot);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int q = (k * kThreads + threadIdx.x) * V;
      const int64_t g = t0 + q;
      T e[V];
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = store_as<T>(s_v[pad<A>(q + j)]);
      if (yvec && g >= shift && g + V <= vend) {
        uint4 w;
        memcpy(&w, e, 16);
        *reinterpret_cast<uint4*>(yb + g) = w;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (g + j >= shift && g + j < vend) yb[g + j] = e[j];
        }
      }
    }
  }

  // the last block done with the scratch resets it
  if (tiles == 1 || !s_last) return;
  __threadfence();
  for (int64_t i = threadIdx.x; i < tiles; i += kThreads) status[i] = 0;
  if (threadIdx.x == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

template <typename A>
constexpr int smem_bytes(bool reduce) {
  return (kTile<A> + (kTile<A> >> kPadShift<A>)) * static_cast<int>(sizeof(A)) +
         (kTile<A> / 32 + 2) * 4 + (reduce ? kTile<A> * 2 : 0);
}

template <typename T, int M>
int run(const void* x, void* y, int64_t n, const Keys& keys, int mode,
        unsigned long long init_bits, void* count, void* status, void* values,
        void* counts, void* lasts, void* counters, cudaStream_t st) {
  using A = typename Carry<T>::type;
  // the dynamic shared-memory limit, once a device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (((configured >> dev) & 1) == 0) {
    cudaFuncSetAttribute(by_key_kernel<T, M>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<A>(true));
    cudaFuncSetAttribute(by_key_kernel<T, M>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    configured |= 1ull << dev;
  }
  const bool reduce = mode == kReduce;
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const int shift = static_cast<int>((xa & 15) / sizeof(T));
  const uintptr_t ya = reduce ? reinterpret_cast<uintptr_t>(y)
                              : reinterpret_cast<uintptr_t>(y) - shift * sizeof(T);
  A init;
  memcpy(&init, &init_bits, sizeof(A));
  const int64_t tiles = (n + shift + kTile<A> - 1) / kTile<A>;
  by_key_kernel<T, M><<<static_cast<unsigned>(tiles), kThreads,
                        smem_bytes<A>(reduce), st>>>(
      reinterpret_cast<const T*>(xa - shift * sizeof(T)), reinterpret_cast<T*>(ya),
      !reduce && (ya & 15) == 0, shift, n, tiles, keys, mode, init,
      static_cast<int64_t*>(count), static_cast<unsigned long long*>(status),
      static_cast<A*>(values), static_cast<long long*>(counts),
      static_cast<unsigned long long*>(lasts), static_cast<unsigned*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_monoid(int mono, const void* x, void* y, int64_t n, const Keys& keys,
              int mode, unsigned long long init, void* count, void* status,
              void* values, void* counts, void* lasts, void* counters,
              cudaStream_t st) {
  switch (mono) {
    case kAdd: return run<T, kAdd>(x, y, n, keys, mode, init, count, status, values, counts, lasts, counters, st);
    case kMax: return run<T, kMax>(x, y, n, keys, mode, init, count, status, values, counts, lasts, counters, st);
    case kMin: return run<T, kMin>(x, y, n, keys, mode, init, count, status, values, counts, lasts, counters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the value-type codes of vex_scan: 0 f32, 1 f64, 2 i32, 3 i64, 4 bf16
template <typename T>
struct TypeCode;
template <>
struct TypeCode<float> {
  static constexpr int value = 0;
};
template <>
struct TypeCode<double> {
  static constexpr int value = 1;
};
template <>
struct TypeCode<int32_t> {
  static constexpr int value = 2;
};
template <>
struct TypeCode<int64_t> {
  static constexpr int value = 3;
};
template <>
struct TypeCode<__nv_bfloat16> {
  static constexpr int value = 4;
};

// One keyed scan or reduce_by_key over the value types Ts... that the
// including library instantiates (another code is an invalid value): the
// body of its C entry vex_by_key.
// A call is one keyed scan (mode 0 inclusive, 1 inclusive with init, 2 exclusive, 3
// exclusive with init: y = the n outputs, y may be x) or reduce_by_key
// (mode 4: y = the run totals, *count (int64) = the number of runs).  The
// nkeys key vectors' pointers are ptrs[0 .. nkeys), and for mode 4 their
// outputs (each key at its run's tail) ptrs[nkeys .. 2 nkeys); key q's code
// is bits 5q .. 5q + 4 of codes: the log2 of its width in bits 0-1, its
// kind (0 integer or bool, 1 f16, 2 bf16, 3 f32, 4 f64; complex keys are
// two float lanes) in bits 2-4.  init: the bits of init in the carry type.
// status, values, counts, lasts: per tile, status and counters zeroed and
// left zeroed.
template <typename... Ts>
int by_key_entry(int dtype, int mono, int mode, int nkeys, long long codes,
                 void* const* ptrs, const void* x, void* y, int64_t n,
                 unsigned long long init, void* count, void* status,
                 void* values, void* counts, void* lasts, void* counters,
                 void* stream) {
  if (n <= 0 || nkeys < 1 || nkeys > kMaxKeys || mode < 0 || mode > kReduce) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Keys keys{};
  keys.count = nkeys;
  for (int q = 0; q < nkeys; ++q) {
    const int code = static_cast<int>((codes >> (5 * q)) & 31);
    KeyVec& kv = keys.k[q];
    kv.log2w = code & 3;
    const auto a = reinterpret_cast<uintptr_t>(ptrs[q]);
    kv.shift = static_cast<int>((a & 15) >> kv.log2w);
    kv.base = reinterpret_cast<const void*>(a & ~static_cast<uintptr_t>(15));
    switch (code >> 2) {
      case kInt: kv.lane = 0; kv.inf = 0; break;
      case kF16: kv.lane = 2; kv.inf = 0x7c00ull; break;
      case kBF16: kv.lane = 2; kv.inf = 0x7f80ull; break;
      case kF32: kv.lane = 4; kv.inf = 0x7f800000ull; break;
      case kF64: kv.lane = 8; kv.inf = 0x7ff0000000000000ull; break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (kv.lane > (1 << kv.log2w)) return static_cast<int>(cudaErrorInvalidValue);
    if (mode == kReduce) keys.out[q] = ptrs[nkeys + q];
  }
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((TypeCode<Ts>::value == dtype &&
    (rc = by_monoid<Ts>(mono, x, y, n, keys, mode, init, count, status, values,
                        counts, lasts, counters, st), true)) ||
   ...);
  return rc;
}

}  // namespace

extern "C" {

// Elements per tile of a value type (codes as for vex_scan: 0 f32, 1 f64,
// 2 i32, 3 i64, 4 bf16; 0 for another code), and tiles per window.  The scratch of a call of n elements holds
// a status word and three 8-byte slots (value, count, last value) per tile
// of n + 15 elements (room for the alignment shift), and two counters.
int vex_by_key_tile(int dtype) {
  switch (dtype) {
    case 0: case 2: case 4: return kTile<float>;
    case 1: case 3: return kTile<double>;
    default: return 0;
  }
}
int vex_by_key_window(void) { return kWindow; }

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
