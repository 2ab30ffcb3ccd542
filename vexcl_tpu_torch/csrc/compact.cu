// Stream compaction for Hopper: the payloads of the flagged positions,
// packed in their original order, and their count on the device.
//
// Replaces the Pallas kernel of vexcl_tpu/ops/pallas_compact.py
// (_compact_kernel, called through pallas_compact) and the compaction half
// of pallas_rbk.py (_fused_kernel, pallas_segscan_rowcompact).  Those
// compact within a block by moving every element left one binary digit of
// its distance at a time with lane rolls, because a TPU has no fast
// scatter, and carry positions and payloads as f32 bit patterns; a sort
// or a gather assembles the blocks afterwards.  Hopper scatters well, so
// here one launch does the whole compaction in a single pass over the
// flags, with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016; the design of
// CUB's DeviceSelect::Flagged).  A block of kThreads threads takes a tile
// of kTile flags, as kRounds sub-tiles of 16 flags a thread:
//
//   1. the block draws its tile id from an atomic ticket, so a tile only
//      ever waits on tiles that have already started, and a grid larger
//      than what is resident cannot deadlock;
//   2. each thread issues its kRounds 16-byte flag loads at once (a
//      warp's load covers 512 neighbouring bytes), turns each into a
//      16-bit mask with byte compares (__vcmpne4) and counts it with
//      __popc; a flags pointer that is not 16-byte aligned is read from
//      the aligned address below it, with the bytes outside [0, n) masked;
//   3. warp shuffles and a scan of the warp totals rank the threads, all
//      rounds at once (the rounds' counts are 16-bit fields of one u64);
//   4. the block publishes its aggregate in its 64-bit status word (state
//      in the top two bits, count below: one store), looks back over its
//      predecessors' words, all its threads at once (kThreads words a
//      round trip), until it meets an inclusive prefix (waiting only on
//      the words before that prefix), and publishes its own;
//   5. the threads list the places of their flagged elements in shared
//      memory, in order (the list, not a rank per element), for as many
//      rounds at once as the list of kSub places holds (all four unless
//      the tile is dense), and each payload is copied from the list by its
//      own group of threads: the payloads' reads are in flight together,
//      neighbouring threads store neighbouring slots, and the copy is
//      specialised on the payload's width (1, 2, 4 or 8 bytes, so any
//      type moves bit for bit) outside the element loop;
//   6. each block then draws a second ticket (the done counter); the block
//      that finishes last reads the count from the last tile's inclusive
//      prefix, writes it, and sets the status words and both counters back
//      to 0 for the next launch on this scratch.  Only the last to finish
//      may reset: until then another block may still be looking back.
//
// What bounds it on this card: the flags are read once, and of each
// payload only the flagged elements are read and written.  For
// reduce_by_key at 2^24 with runs of 64: 16.8 MB of flags and 2 x (1 + 1)
// MB of two 4-byte payloads, 6.3 us at 3.35 TB/s.  Each flagged element
// read costs a 32-byte sector of device memory when the flags are sparse
// (one in 64 there), so moving the bytes takes nearer 11 us.  Beyond the
// bytes, a tile's life is a chain of latencies: its flag loads, the
// look-back's round trips to L2, and the payload reads of each list.  The
// tile (512 threads, 4 rounds: 32768 flags) puts 2^24 flags in 512 tiles,
// all resident at once on 132 SMs (4 blocks of 512 threads an SM, at 32
// registers by the launch bound), so the chains of every tile overlap and
// each look-back ends in one round trip.
//
// Scratch, cached by the wrapper per (device, stream): one status word
// per tile and the two counters, all 0 between launches.
//
// Plain C interface for ctypes: the entry launches on the given stream
// and returns the CUDA error of the launch (0 when it was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;                 // 16-byte flag loads per thread
constexpr int kSub = kThreads * 16;        // flags per round: a sub-tile
constexpr int kTile = kSub * kRounds;      // flags per block
constexpr int kMaxPayloads = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRounds <= 4, "a round's bits and count are u64 fields");
static_assert(kSub * kRounds <= 65536, "a listed place is a u16");

// a status word: 0 (nothing published), or the state and a count
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCount = kAggregate - 1;

struct Payloads {
  const void* src[kMaxPayloads];
  void* dst[kMaxPayloads];
  int log2size[kMaxPayloads];
  int count;
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

// the low k bits (k clamped to 0 .. 16)
__device__ __forceinline__ unsigned low_bits(int64_t k) {
  return k >= 16 ? 0xffffu : (k <= 0 ? 0u : (1u << k) - 1u);
}

// 16-bit field r of a packed word
__device__ __forceinline__ int field(unsigned long long w, int r) {
  return static_cast<int>((w >> (16 * r)) & 0xffffu);
}

// The lowest thread of the block for which pred holds (kThreads if none).
// s: kWarps ints of shared memory; two barriers.
__device__ __forceinline__ int first_thread(bool pred, int* s) {
  const unsigned b = __ballot_sync(kFull, pred);
  if ((threadIdx.x & 31) == 0) {
    s[threadIdx.x >> 5] = b != 0 ? __ffs(b) - 1 : 32;
  }
  __syncthreads();
  int first = kThreads;
#pragma unroll
  for (int k = kWarps - 1; k >= 0; --k) {
    if (s[k] < 32) first = 32 * k + s[k];
  }
  __syncthreads();
  return first;
}

// The block's sum of v (every thread gets it); s: kWarps long longs.
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

// The exclusive prefix of tile t (> 0): the counts of its predecessors,
// summed from their status words back to the nearest inclusive prefix,
// kThreads words a round (thread i reads tile end - i), run by the whole
// block.  A round waits only for the words before its nearest inclusive
// prefix: a slower tile further back does not hold it.
__device__ long long look_back(const unsigned long long* status, int64_t t,
                               int* s_first, long long* s_sum) {
  long long excl = 0;
  for (int64_t end = t - 1;; end -= kThreads) {
    const int64_t i = end - threadIdx.x;
    unsigned long long w = i >= 0 ? load_acquire(status + i) : kPrefix;
    int stop;
    while (true) {
      stop = first_thread((w & kPrefix) != 0, s_first);
      const int hole = first_thread(w == 0, s_first);
      if (hole > stop || hole == kThreads) break;
      if (w == 0) {   // not published yet: read it again
        __nanosleep(32);
        w = load_acquire(status + i);
      }
    }
    excl += block_sum(static_cast<int>(threadIdx.x) <= stop
                          ? static_cast<long long>(w & kCount) : 0,
                      s_sum);
    if (stop < kThreads) return excl;
  }
}

// dst[out + j] = src[g + idx[j]] for j = j0, j0 + stride, ... < count:
// neighbouring threads take neighbouring j, so the stores are coalesced
// and the loads in order.
template <typename W>
__device__ __forceinline__ void copy_listed(const void* src, void* dst,
                                            int64_t g, int64_t out,
                                            const uint16_t* idx, int count,
                                            int j0, int stride) {
  const W* __restrict__ s = static_cast<const W*>(src) + g;
  W* __restrict__ d = static_cast<W*>(dst) + out;
#pragma unroll 4
  for (int j = j0; j < count; j += stride) d[j] = s[idx[j]];
}

// at most 32 registers, so that 2048 / kThreads blocks fit an SM and a
// 2^24-flag call is one wave of tiles
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    compact_kernel(const uint8_t* __restrict__ base, int shift, int64_t n,
                   int64_t tiles, Payloads p,
                   unsigned long long* __restrict__ status,
                   unsigned* __restrict__ counters,
                   int64_t* __restrict__ count) {
  __shared__ int64_t s_tile;
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_total;
  __shared__ int s_first[kWarps];
  __shared__ long long s_sum[kWarps];
  __shared__ uint16_t s_idx[kSub];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(&counters[0], 1u);
  __syncthreads();
  const int64_t tile = s_tile;

  // round r: this thread's 16 flags at positions v .. v + 15 from the
  // aligned base (element v - shift), those outside [0, n) masked
  const int64_t t0 = tile * kTile;
  const int64_t vend = n + shift;
  uint4 chunk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t v = t0 + r * kSub + 16 * threadIdx.x;
    chunk[r] = v < vend ? __ldcs(reinterpret_cast<const uint4*>(base + v))
                        : make_uint4(0, 0, 0, 0);
  }
  // the rounds' flag bits and their counts, 16 bits a round
  unsigned long long bits = 0, mine = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t v = t0 + r * kSub + 16 * threadIdx.x;
    const unsigned b = nonzero_bits(chunk[r]) & low_bits(vend - v) &
                       ~low_bits(shift - v);
    bits |= static_cast<unsigned long long>(b) << (16 * r);
    mine |= static_cast<unsigned long long>(__popc(b)) << (16 * r);
  }

  // rank, all rounds at once (no field's sum exceeds kSub < 2^16): warp
  // shuffles, then warp 0 scans the warp totals
  unsigned long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long wt = lane < kWarps ? s_warp[lane] : 0;
    unsigned long long wi = wt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kWarps) s_warp[lane] = wi - wt;
    if (lane == 31) s_total = wi;
  }
  __syncthreads();
  const unsigned long long total = s_total;
  const unsigned long long before = s_warp[warp] + incl - mine;
  long long aggregate = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) aggregate += field(total, r);
  long long out = 0;
  if (tile == 0) {
    if (threadIdx.x == 0) store_release(status, kPrefix | aggregate);
  } else {
    if (threadIdx.x == 0) store_release(status + tile, kAggregate | aggregate);
    out = look_back(status, tile, s_first, s_sum);
    if (threadIdx.x == 0) {
      store_release(status + tile, kPrefix | (out + aggregate));
    }
  }

  // the selected flags' places, listed in order in shared memory for as
  // many consecutive rounds at a time as the list holds (all of them
  // unless the tile is dense), then each payload copied from the list by
  // its own group of threads, so the payloads' reads are in flight
  // together
  const int group = p.count > 0 ? kThreads / p.count : kThreads;
  const int q = threadIdx.x / group;
#pragma unroll 1
  for (int r0 = 0, r1; r0 < kRounds; r0 = r1) {
    int listed = 0;
    for (r1 = r0; r1 < kRounds && listed + field(total, r1) <= kSub; ++r1) {
      listed += field(total, r1);
    }
    if (listed == 0 || p.count == 0) continue;
    for (int r = r0, k0 = 0; r < r1; k0 += field(total, r), ++r) {
      int k = k0 + field(before, r);
      for (unsigned m = field(bits, r); m != 0; m &= m - 1) {
        s_idx[k++] = static_cast<uint16_t>((r - r0) * kSub +
                                           16 * threadIdx.x + __ffs(m) - 1);
      }
    }
    __syncthreads();
    if (q < p.count) {
      const int64_t g = t0 + r0 * kSub - shift;   // element of place 0
      const int j0 = threadIdx.x - q * group;
      const void* src = p.src[q];
      void* dst = p.dst[q];
      switch (p.log2size[q]) {
        case 0:
          copy_listed<uint8_t>(src, dst, g, out, s_idx, listed, j0, group);
          break;
        case 1:
          copy_listed<uint16_t>(src, dst, g, out, s_idx, listed, j0, group);
          break;
        case 2:
          copy_listed<uint32_t>(src, dst, g, out, s_idx, listed, j0, group);
          break;
        default:
          copy_listed<uint64_t>(src, dst, g, out, s_idx, listed, j0, group);
      }
    }
    out += listed;
    __syncthreads();
  }

  // the last block to finish writes the count and resets the scratch
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[1], 1u) == static_cast<unsigned>(tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    *count = static_cast<int64_t>(load_acquire(status + tiles - 1) & kCount);
    counters[0] = 0;
    counters[1] = 0;
  }
  __syncthreads();   // the count is read before its word is cleared
  for (int64_t i = threadIdx.x; i < tiles; i += kThreads) status[i] = 0;
}

}  // namespace

extern "C" {

// Flags per tile: the status scratch holds one word per tile of n + 15
// flags (room for the alignment shift).
int vex_compact_tile(void) { return kTile; }

// Pack the elements of each payload at the nonzero flags, in order, and
// write their number to *count (int64).  ptrs: npay sources, then npay
// destinations; log2sizes: 2 bits per payload, the log2 of its element
// size in bytes, payload q at bits 2q.  status: zeroed words, at least one
// per tile; counters: two zeroed u32.  Both are left zeroed.
int vex_compact(const void* flags, int64_t n, int npay, int log2sizes,
                void* const* ptrs, void* count, void* status,
                void* counters, void* stream) {
  if (npay < 0 || npay > kMaxPayloads || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Payloads p{};
  for (int q = 0; q < npay; ++q) {
    p.src[q] = ptrs[q];
    p.dst[q] = ptrs[npay + q];
    p.log2size[q] = (log2sizes >> (2 * q)) & 3;
  }
  p.count = npay;
  const auto addr = reinterpret_cast<uintptr_t>(flags);
  const int shift = n > 0 ? static_cast<int>(addr & 15) : 0;
  const auto* base = reinterpret_cast<const uint8_t*>(addr - shift);
  const int64_t tiles = n > 0 ? (n + shift + kTile - 1) / kTile : 1;
  compact_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      base, shift, n, tiles, p, static_cast<unsigned long long*>(status),
      static_cast<unsigned*>(counters), static_cast<int64_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
