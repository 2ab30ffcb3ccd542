// Inclusive scan, plain and segmented, for Hopper: one launch a call.
//
// Replaces the Pallas kernels of vexcl_tpu/ops/pallas_scan.py
// (_scan_kernel, called through pallas_cumsum), pallas_monoid_scan.py
// (_mono_kernel: pallas_cummax, pallas_cummin) and pallas_segscan.py
// (_seg_kernel: pallas_segmented_cumsum_flags, pallas_segmented_cumsum),
// and the scan half of pallas_rbk.py (_fused_kernel).  Those run the grid
// in order on one TPU core and thread a running total through SMEM from
// one block to the next; their triangular MXU products and lane rolls are
// TPU idioms.  CUDA blocks run at once and in no order, so here one launch
// scans in a single pass over x with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), under a rule that fixes the order of every combination:
//
//   1. a block draws its tile id from an atomic ticket, so a tile only
//      ever waits on tiles that have already started, and a grid larger
//      than what is resident cannot deadlock;
//   2. it reads its tile of kTile = kThreads x kItems elements (kItems = 32
//      for a 4-byte carry, 16 for an 8-byte one) as 16-byte
//      vectors into shared memory (a pointer that is not 16-byte aligned
//      is read from the aligned address below it, the elements outside
//      [0, n) taken as the identity), and each thread its kItems head
//      flags as 16-byte loads turned into a bit mask in registers; then
//      thread t scans elements t*kItems ... t*kItems + kItems - 1 in order
//      and a block-wide scan of the threads' aggregates gives each its
//      exclusive prefix in the tile and the tile's aggregate AGG(t);
//   3. tiles are grouped in windows of kWindow = kThreads tiles.  Tile t in
//      window [b, b + kWindow) takes as its exclusive prefix P(b - 1) . F,
//      where F is the block-wide fold, in thread order, of AGG(b) ...
//      AGG(t - 1) (thread i reads AGG(b + i)), and P(b - 1) is the
//      inclusive prefix that the last tile of the window before publishes
//      (the identity in the first window); only that tile publishes one.
//      So every tile uses the same formula whatever the timing, and the
//      same input gives the same bits (CUB's look-back stops at whichever
//      predecessor happens to have published an inclusive prefix, so the
//      bracketing of its float sums depends on timing).  The block waits
//      for the window's aggregates together, and then one thread for
//      P(b - 1), so the serial chain, tiles / kWindow links (8 at 2^24
//      f32 elements, 16 in f64), costs one round trip and one combine a
//      link.  Segmented: where F holds a head, P(b - 1) . F is F, and
//      P(b - 1) is not waited for (with a head in every tile, no tile waits
//      on the chain);
//   4. a tile publishes AGG(t), or P(t) if it ends its window, in its own
//      64-bit status word with one st.release.gpu: state, head flag and a
//      4-byte carry in one word; an 8-byte carry is stored in its own array
//      before the release of the word and read after its acquire;
//   5. the block rescans its elements from the prefix in shared memory and
//      stores them, as 16-byte vectors where y has x's alignment.  A tile is
//      read whole before any of it is written, so y may be x (in place);
//   6. once done with the scratch (after its look-back and its last word)
//      each block draws a second ticket (the done counter), before its
//      stores, so that the round trip overlaps them; the last to draw it
//      sets the status words and both counters back to 0 for the next
//      launch on this scratch.  Only the last may reset: until then another
//      block may still be looking back.  A single tile (n + the
//      alignment shift <= kTile) uses no scratch and skips the look-back.
//
// One template covers the monoid (add, max, min), the value type (f32,
// f64, i32, i64, and bf16 carried in f32) and the segmented flag (u8 head
// flags, nonzero where a segment starts).  MAX and MIN propagate NaN as
// jnp.maximum and jnp.minimum do (CUDA's fmaxf/fminf drop it); integer sums
// wrap in their own type, as XLA's do.  The segmented form combines (head
// flag, value) pairs as (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1,
// v2)), which is associative for any associative op.  No atomics touch a
// value: every combination runs in a fixed order.
//
// Bound on this card: x read once and y written once, 2 x 67 MB for 2^24
// f32, 40 us at 3.35 TB/s (f64 80 us); the segmented form adds 17 MB of
// flags.  What holds it above that is the life of a tile: its slot on the
// SM stays taken through the ticket's round trip, the loads, the wait for
// the window's aggregates (the tiles just before it started with it) and
// for P(b - 1), and the stores, while only the loads and stores move
// bytes.  Tiles of 32 KB of carry (8192 f32 or 4096 f64 elements) and the
// launch bound (at most 64 registers, four blocks an SM) keep 128 KB of
// tiles on each SM and halve the look-backs against 4096-element f32
// tiles; the done ticket is drawn before the stores (step 6).
//
// Scratch, cached by the wrapper per (device, stream): one status word per
// tile, one 8-byte value per tile for an 8-byte carry, and two counters;
// the status words and counters are 0 between launches.
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns the CUDA error of the launch (0 when it was accepted).

#include "scan_common.cuh"

namespace {

// bit i set where byte i of the 16 is nonzero
__device__ __forceinline__ unsigned nonzero_bits(uint4 w) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // 0x01 in each nonzero byte; the product gathers the four bytes' low
    // bits into bits 24..27 (every partial product lands on its own bit)
    const unsigned ones = __vcmpne4(words[i], 0u) & 0x01010101u;
    bits |= ((ones * 0x01020408u) >> 24) << (4 * i);
  }
  return bits;
}

// the low k bits (k clamped to 0 .. 32)
__device__ __forceinline__ unsigned low_bits(int64_t k) {
  return k >= 32 ? 0xffffffffu : (k <= 0 ? 0u : (1u << k) - 1u);
}

// Bit j set where heads[e0 + j] is nonzero and 0 <= e0 + j < n, for j < K
// (16 or 32); heads = hb + hshift with hb 16-byte aligned.  The K flags
// are read as the aligned 16-byte chunks that hold them (K / 16 of them,
// one more where heads[e0] does not start one); a chunk with no byte of
// heads is not read.
template <int K>
__device__ __forceinline__ unsigned head_bits(const uint8_t* hb, int hshift,
                                              int64_t e0, int64_t n) {
  const int64_t p = e0 + hshift;           // heads[e0] is hb[p]
  const int d = static_cast<int>(p & 15);
  const int64_t c = p - d;                 // its chunk
  const int64_t lo = hshift, hi = hshift + n;
  unsigned long long m = 0;
#pragma unroll
  for (int k = 0; k <= K / 16; ++k) {
    const int64_t ck = c + 16 * k;
    if ((k < K / 16 || d != 0) && ck < hi && ck + 16 > lo) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(hb + ck));
      m |= static_cast<unsigned long long>(nonzero_bits(w)) << (16 * k);
    }
  }
  return static_cast<unsigned>(m >> d) & low_bits(K) & low_bits(n - e0) &
         ~low_bits(-e0);
}

// x = xb + shift and y = yb + shift (elements), xb 16-byte aligned, and yb
// too when yvec; a tile covers positions [tile * kTile, (tile + 1) * kTile)
// from xb (kTile of the carry type).  x and y may be the same array: not __restrict__.
template <typename T, int M, bool SEG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_kernel(const T* xb, T* yb, bool yvec, int shift, const uint8_t* hb,
                int hshift, int64_t n, int64_t tiles,
                unsigned long long* status, typename Carry<T>::type* values,
                unsigned* counters) {
  using A = typename Carry<T>::type;
  using Scan = BlockScan<M, A, SEG>;
  constexpr int kIt = kItems<A>;
  constexpr int kT = kTile<A>;
  constexpr int V = 16 / sizeof(T);        // elements a 16-byte vector
  constexpr int kLoads = kIt / V;          // vectors a thread
  __shared__ A s_v[kT + (kT >> kPadShift<A>)];
  __shared__ typename Scan::Storage s_scan;
  __shared__ int64_t s_tile;
  __shared__ bool s_last;

  int64_t tile = 0;
  if (tiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&counters[0], 1u);
    __syncthreads();
    tile = s_tile;
  }
  const int64_t t0 = tile * kT;
  const int64_t vend = n + shift;

  // the tile's vectors, all in flight at once, then into shared memory
  uint4 chunk[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t v = t0 + static_cast<int64_t>(k * kThreads + threadIdx.x) * V;
    chunk[k] = v < vend ? __ldcs(reinterpret_cast<const uint4*>(xb + v))
                        : make_uint4(0, 0, 0, 0);
  }
  const int i0 = threadIdx.x * kIt;        // this thread's first element
  unsigned bits = 0;
  if constexpr (SEG) bits = head_bits<kIt>(hb, hshift, t0 + i0 - shift, n);
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

  // this thread's aggregate, then its prefix in the tile and the tile's
  A v = s_v[pad<A>(i0)];
  bool f = SEG && (bits & 1u) != 0;
#pragma unroll
  for (int j = 1; j < kIt; ++j) {
    const A e = s_v[pad<A>(i0 + j)];
    if (SEG && ((bits >> j) & 1u) != 0) {
      v = e;
      f = true;
    } else {
      v = Op<M, A>::f(v, e);
    }
  }
  A tv;
  bool tf;
  Scan::exclusive(v, f, tv, tf, s_scan);

  if (tiles > 1) {
    const bool ends_window = tile % kWindow == kWindow - 1;
    const bool read_later = tile < tiles - 1;
    if (threadIdx.x == 0 && !ends_window && read_later) {
      publish(status, values, tile, tv, tf);
    }
    if (tile > 0) {
      A pv;
      bool pf;
      look_back<M, A, SEG>(status, values, tile, pv, pf, s_scan);
      if (threadIdx.x == 0 && ends_window && read_later) {
        combine<M, A, SEG>(tv, tf, pv, pf);
        publish(status, values, tile, tv, tf);
      }
      combine<M, A, SEG>(v, f, pv, pf);
    }
    // the tile is done with the scratch: draw the done ticket now, so that
    // its round trip overlaps the stores (the fence waits only for this
    // tile's status word, not for its y)
    if (threadIdx.x == 0) {
      __threadfence();
      s_last = atomicAdd(&counters[1], 1u) == static_cast<unsigned>(tiles - 1);
    }
  }

  // v is now the combination of everything before this thread's elements
  A run = v;
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int p = pad<A>(i0 + j);
    const A e = s_v[p];
    run = (SEG && ((bits >> j) & 1u) != 0) ? e : Op<M, A>::f(run, e);
    s_v[p] = run;
  }
  __syncthreads();
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

  // the last block done with the scratch resets it (s_last was set before
  // the barrier above the stores)
  if (tiles == 1 || !s_last) return;
  __threadfence();
  for (int64_t i = threadIdx.x; i < tiles; i += kThreads) status[i] = 0;
  if (threadIdx.x == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

template <typename T, int M, bool SEG>
int run(const void* x, const void* heads, void* y, int64_t n, void* status,
        void* values, void* counters, cudaStream_t st) {
  using A = typename Carry<T>::type;
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const int shift = static_cast<int>((xa & 15) / sizeof(T));
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y) - shift * sizeof(T);
  const auto ha = reinterpret_cast<uintptr_t>(heads);
  const int hshift = static_cast<int>(ha & 15);
  const int64_t tiles = (n + shift + kTile<A> - 1) / kTile<A>;
  scan_kernel<T, M, SEG><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      reinterpret_cast<const T*>(xa - shift * sizeof(T)), reinterpret_cast<T*>(ya),
      (ya & 15) == 0, shift, reinterpret_cast<const uint8_t*>(ha - hshift), hshift,
      n, tiles, static_cast<unsigned long long*>(status), static_cast<A*>(values),
      static_cast<unsigned*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SEG>
int by_monoid(int mono, const void* x, const void* heads, void* y, int64_t n,
              void* status, void* values, void* counters, cudaStream_t st) {
  switch (mono) {
    case kAdd: return run<T, kAdd, SEG>(x, heads, y, n, status, values, counters, st);
    case kMax: return run<T, kMax, SEG>(x, heads, y, n, status, values, counters, st);
    case kMin: return run<T, kMin, SEG>(x, heads, y, n, status, values, counters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype codes: 0 f32, 1 f64, 2 i32, 3 i64, 4 bf16
template <bool SEG>
int by_type(int dtype, int mono, const void* x, const void* heads, void* y,
            int64_t n, void* status, void* values, void* counters, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_monoid<float, SEG>(mono, x, heads, y, n, status, values, counters, st);
    case 1: return by_monoid<double, SEG>(mono, x, heads, y, n, status, values, counters, st);
    case 2: return by_monoid<int32_t, SEG>(mono, x, heads, y, n, status, values, counters, st);
    case 3: return by_monoid<int64_t, SEG>(mono, x, heads, y, n, status, values, counters, st);
    case 4:
      return by_monoid<__nv_bfloat16, SEG>(mono, x, heads, y, n, status, values,
                                           counters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Elements per tile of a value type (dtype codes as for vex_scan; 0 for
// another code), and tiles per look-back window.  The scratch of a call of
// n elements holds one status word and one 8-byte value per tile of
// n + 15 elements (room for the alignment shift), and two counters.
int vex_scan_tile(int dtype) {
  switch (dtype) {
    case 0: case 2: case 4: return kTile<float>;
    case 1: case 3: return kTile<double>;
    default: return 0;
  }
}
int vex_scan_window(void) { return kWindow; }

// y = inclusive scan of x (n > 0 elements; y may be x).  status: zeroed
// u64 words; values: 8-byte slots; counters: two zeroed u32.  The status
// words and counters are left zeroed.
int vex_scan(int dtype, int mono, const void* x, void* y, int64_t n,
             void* status, void* values, void* counters, void* stream) {
  return by_type<false>(dtype, mono, x, nullptr, y, n, status, values, counters,
                        stream);
}

// y = segmented inclusive scan of x, a segment starting at every nonzero
// u8 head flag (y may be x); the scratch as for vex_scan.
int vex_segscan(int dtype, int mono, const void* heads, const void* x, void* y,
                int64_t n, void* status, void* values, void* counters,
                void* stream) {
  return by_type<true>(dtype, mono, x, heads, y, n, status, values, counters,
                       stream);
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
