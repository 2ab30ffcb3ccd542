// Gather through a permutation for Hopper: out[i] = src[j], j =
// int32(idx[i]), for sources of 4- and 8-byte elements (f32, i32, f64,
// i64: a gather moves bits, so the kernels are typed by width alone).
//
// Replaces, for the sizes ops/cuda_gather.py's route sends here, the
// indexed loads of V1's generated Triton kernel (expr/triton_emit.py,
// PermutationView.emit_index: one load a lane at its index), which stands
// where the JAX package has XLA's gather (vexcl_tpu/expr/view.py:283-286,
// jnp.take(x, idx.astype(int32))).  The index rule is jnp.take's: the
// index is truncated to i32, a negative one wraps once by +N, and one
// still out of range reads the fill (NaN, the least signed integer),
// whose bits the wrapper passes.
//
// The same kernels serve gathers at the flat index of two coordinate
// arrays, always in range: a nearest 2-D image sample and slicer[i, j]
// (vexcl_tpu/ops/image.py:57-60, vexcl_tpu/expr/view.py:217-224), through
// vex_gather_coords, whose partition computes the index itself
// (CoordPair).  A generated pass that wrote the i32 index first, for
// vex_gather_ranges to read, cost 22% of that two-pass call (PERF.md §6).
//
// What bounds the single pass on this card: each random 4-byte load pulls
// its own 32-byte sector, and a source larger than the 50 MB L2 (2^24
// f32 is 64 MB) misses it: 537 MB of sectors for 2^24 loads, which arrive
// at about half the streaming rate, 389 us against a 60 us bound
// (index_select ties it).  Reading the source one L2-resident range of
// megabytes at a time does not cure it: the random loads then hit L2, but
// 2^24 of them still take ~165 us at the L2's rate of random sectors,
// whatever the range (2-8 MB on an H100; PERF.md §6).  So the range is one
// block's shared memory, and the random reads never leave the SM.  Three
// kernels:
//
//   (1) partition_kernel: a block a tile of `tile` destinations (at most
//       2^15, so that an offset fits in u16) loads the tile's indices,
//       applies the rule and counting-sorts the tile's entries by source
//       range r = j >> log_s in shared memory (shared-memory atomics, one
//       a warp where the warp's entries share a range, as a sorted index's
//       do; the out-of-range entries in a bucket of their own, the last).
//       It
//       writes, in that order, each entry's index within its range and its
//       destination's offset in the tile (u16 each: a range is at most
//       2^16 elements), and the tile's bucket starts into column t of a
//       bucket-major matrix, so that a range's starts over the tiles are
//       one row.
//   (2) gather_kernel: a block a range loads the range into shared memory
//       (16-byte loads, the source read once), then walks the range's runs
//       over all the tiles: their first places and an exclusive scan of
//       their lengths go to shared memory, each warp takes an equal share
//       of the entries (so that one long run, as a sorted index makes, is
//       shared too) and covers it 32 entries at a time through windows of
//       32 tiles, a lane each (each lane finds its run by a binary search
//       over the window's lanes), reading each entry's index within the
//       range, the value from shared memory, and writing the value at the
//       entry's place.  The last bucket writes the fill.
//   (3) restore_kernel: a block a tile reads the tile's values and
//       offsets, puts each value at its offset in shared memory and writes
//       the tile of out in 16-byte stores.
//
// At 2^24 f32 through a permutation this moves ~465 MB, none of it at
// random in device memory: (1) reads 67 MB and writes 67 MB, (2) reads 33
// MB of indices and the 64 MB source once and writes 67 MB, (3) reads 100
// MB and writes 67 MB: ~0.139 ms at 3.35 TB/s.  The streamed arrays are
// read and written with the evict-first hints (__ldcs, __stcs).  The
// source and the index are read before out is written, each kernel after
// the last on one stream, so an index or a source that shares out's
// memory reads its old values.
//
// Plain C interface for ctypes: the entry launches on the given stream,
// allocates nothing, does not synchronise, and returns the CUDA error of
// its launches (0 when they were accepted).

#include <cuda_runtime.h>

#include <cstdint>

#include "ranges_common.cuh"

namespace {

constexpr int kPartThreads = 512;       // (1)
constexpr int kPartUnroll = 4;
constexpr int kPlaceRun = 16;           // entries a thread places a round
constexpr int kGatherThreads = 512;     // (2)
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherUnroll = 4;
constexpr int kGatherChunk = 1024;      // tiles a round of (2)
constexpr int kRestoreThreads = 512;    // (3)
constexpr int kMaxTile = 1 << 15;
constexpr int kMaxLogS = 16;            // a range's index fits in u16
constexpr int kMaxRanges = 8192;
constexpr int kMaxSmem = 227 * 1024;

// jnp.take's index rule: truncate to i32, wrap a negative index once by
// +N; -1 for an index still out of range
template <typename I>
__device__ __forceinline__ int source_index(I raw, int N) {
  int j = static_cast<int>(static_cast<uint32_t>(raw));
  j = j < 0 ? j + N : j;
  return static_cast<unsigned>(j) < static_cast<unsigned>(N) ? j : -1;
}

// the bucket of source index j (the last for an index out of range)
__device__ __forceinline__ int bucket_of(int j, int ranges, int log_s) {
  return j < 0 ? ranges : (j >> log_s);
}

// whether every one of this warp's entries (b[] of each lane; < 0: none,
// and a lane without entries has none after it) lies in lane 0's first
// bucket, as a sorted index's do; all 32 lanes call it
template <int K>
__device__ __forceinline__ bool warp_uniform(const int (&b)[K]) {
  const int b0 = __shfl_sync(kFull, b[0], 0);
  bool same = true;
#pragma unroll
  for (int c = 0; c < K; ++c) same = same && (b[c] == b0 || b[c] < 0);
  return __all_sync(kFull, same);
}

// Where (1) takes each entry's source index from: an index array, by
// jnp.take's rule (IndexArray), or two coordinate arrays that (1) turns
// into a flat index itself (CoordPair: the fused variant).  Each gives
// kVec entries a 16-byte load (load, at) where the arrays are 16-byte
// aligned (aligned), else one entry at a time (one).
template <typename I>
struct IndexArray {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(I));
  struct Pack {
    uint4 q;
  };
  const I* idx;
  int N;
  __device__ bool aligned() const {
    return (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  }
  __device__ Pack load(int64_t i) const {
    return {__ldcs(reinterpret_cast<const uint4*>(idx + i))};
  }
  __device__ int at(const Pack& p, int c) const {
    return source_index(reinterpret_cast<const I*>(&p.q)[c], N);
  }
  __device__ int one(int64_t i) const { return source_index(idx[i], N); }
};

// a coordinate of a CoordPair before its clamp: a float rounded half to
// even and converted saturating, NaN 0 (cvt.rni: an image's nearest
// sample, as Emitter.cast converts it), an integer key wrapped once by +d
// (a slicer's index-array key)
__device__ __forceinline__ int64_t raw_coord(float v, int) {
  return __float2int_rn(v);
}
__device__ __forceinline__ int64_t raw_coord(double v, int) {
  return __double2int_rn(v);
}
__device__ __forceinline__ int64_t raw_coord(int v, int d) {
  return v < 0 ? static_cast<int64_t>(v) + d : v;
}
__device__ __forceinline__ int64_t raw_coord(long long v, int d) {
  return v < 0 ? v + d : v;
}

// j = base + c0 * s0 + c1 * s1, each coordinate clamped into [0, d): in
// range by construction
template <typename T>
struct CoordPair {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  struct Pack {
    uint4 a, b;
  };
  const T* a;
  const T* b;
  int64_t base, s0, s1;
  int d0, d1;
  __device__ bool aligned() const {
    return ((reinterpret_cast<uintptr_t>(a) |
             reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  }
  __device__ Pack load(int64_t i) const {
    return {__ldcs(reinterpret_cast<const uint4*>(a + i)),
            __ldcs(reinterpret_cast<const uint4*>(b + i))};
  }
  __device__ static int64_t clamped(T v, int d) {
    const int64_t c = raw_coord(v, d);
    return c < 0 ? 0 : (c >= d ? d - 1 : c);
  }
  __device__ int index(T va, T vb) const {
    return static_cast<int>(base + clamped(va, d0) * s0 +
                            clamped(vb, d1) * s1);
  }
  __device__ int at(const Pack& p, int c) const {
    return index(reinterpret_cast<const T*>(&p.a)[c],
                 reinterpret_cast<const T*>(&p.b)[c]);
  }
  __device__ int one(int64_t i) const { return index(a[i], b[i]); }
};

// shared memory of (1): the tile's source indices in destination order
// (i32), the sorted order's offsets (u16), a counter a bucket
__host__ __device__ constexpr int partition_smem(int tile, int buckets) {
  return tile * 6 + buckets * 4;
}

// (1) starts[b * tiles + t]: the first place of bucket b in tile t's
// sorted order (row ranges + 1: the tile's length); sidx, soff: the tile's
// entries in bucket order, each's index within its range (0 out of range)
// and its destination's offset in the tile
template <typename P>
__global__ void __launch_bounds__(kPartThreads)
    partition_kernel(P ix, int64_t n, int log_s, int ranges, int tile,
                     int tiles, uint32_t* __restrict__ starts,
                     uint16_t* __restrict__ sidx,
                     uint16_t* __restrict__ soff) {
  extern __shared__ __align__(16) unsigned char psmem[];
  __shared__ uint32_t warp_sums[kPartThreads / 32];
  int32_t* sj = reinterpret_cast<int32_t*>(psmem);
  uint16_t* so = reinterpret_cast<uint16_t*>(sj + tile);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(so + tile);
  const int buckets = ranges + 1;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < buckets; b += kPartThreads) cnt[b] = 0;
  __syncthreads();
  const int t = blockIdx.x;
  const int64_t begin = static_cast<int64_t>(t) * tile;
  const int len = static_cast<int>(n - begin < tile ? n - begin : tile);
  // the indices: kPartUnroll 16-byte loads (of each array) in flight a
  // thread where the arrays are 16-byte aligned (a tile starts at a
  // multiple of 8), the rest one entry a load; each round's bounds are the
  // block's, so that every lane of a warp takes part in warp_uniform
  constexpr int kVec = P::kVec;
  int from = 0;
  if (ix.aligned()) {
    const int whole = len / kVec * kVec;
    for (int e0 = 0; e0 < whole; e0 += kPartThreads * kVec * kPartUnroll) {
      typename P::Pack q[kPartUnroll];
#pragma unroll
      for (int u = 0; u < kPartUnroll; ++u) {
        const int e = e0 + (u * kPartThreads + threadIdx.x) * kVec;
        if (e < whole) q[u] = ix.load(begin + e);
      }
      int b[kPartUnroll * kVec];
      uint32_t mine = 0;
#pragma unroll
      for (int u = 0; u < kPartUnroll; ++u) {
        const int e = e0 + (u * kPartThreads + threadIdx.x) * kVec;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          b[u * kVec + c] = -1;
          if (e < whole) {
            const int j = ix.at(q[u], c);
            sj[e + c] = j;
            b[u * kVec + c] = bucket_of(j, ranges, log_s);
          }
        }
        mine += e < whole ? kVec : 0;
      }
      // one atomic a warp where the round's entries share a bucket
      if (warp_uniform(b)) {
        const uint32_t all = __reduce_add_sync(kFull, mine);
        if (lane == 0 && b[0] >= 0) atomicAdd(&cnt[b[0]], all);
      } else {
#pragma unroll
        for (int c = 0; c < kPartUnroll * kVec; ++c) {
          if (b[c] >= 0) atomicAdd(&cnt[b[c]], 1u);
        }
      }
    }
    from = whole;
  }
  for (int e = from + threadIdx.x; e < len; e += kPartThreads) {
    const int j = ix.one(begin + e);
    sj[e] = j;
    atomicAdd(&cnt[bucket_of(j, ranges, log_s)], 1u);
  }
  __syncthreads();
  // the buckets' starts: each thread a run of neighbouring buckets
  const int per = (buckets + kPartThreads - 1) / kPartThreads;
  const int b0 = threadIdx.x * per;
  uint32_t sum = 0;
  for (int q = 0; q < per; ++q) {
    if (b0 + q < buckets) sum += cnt[b0 + q];
  }
  uint32_t all;
  uint32_t at = block_exclusive_scan<kPartThreads>(sum, warp_sums, &all);
  for (int q = 0; q < per; ++q) {
    const int b = b0 + q;
    if (b < buckets) {
      const uint32_t c = cnt[b];
      cnt[b] = at;
      starts[static_cast<int64_t>(b) * tiles + t] = at;
      at += c;
    }
  }
  if (threadIdx.x == 0) {
    starts[static_cast<int64_t>(buckets) * tiles + t] = len;
  }
  __syncthreads();
  // each entry's place in bucket order, kPlaceRun neighbouring entries a
  // thread: one atomic a warp where the warp's entries share a bucket
  // (their places then follow the entries' order), else one an entry
  const int whole_runs = len / kPlaceRun * kPlaceRun;
  for (int e0 = 0; e0 < whole_runs; e0 += kPartThreads * kPlaceRun) {
    const int e = e0 + threadIdx.x * kPlaceRun;
    int b[kPlaceRun];
#pragma unroll
    for (int c = 0; c < kPlaceRun; c += 4) {
      int4 j4 = make_int4(-1, -1, -1, -1);
      if (e < whole_runs) j4 = *reinterpret_cast<const int4*>(sj + e + c);
      const bool in = e < whole_runs;
      b[c] = in ? bucket_of(j4.x, ranges, log_s) : -1;
      b[c + 1] = in ? bucket_of(j4.y, ranges, log_s) : -1;
      b[c + 2] = in ? bucket_of(j4.z, ranges, log_s) : -1;
      b[c + 3] = in ? bucket_of(j4.w, ranges, log_s) : -1;
    }
    if (warp_uniform(b)) {
      const uint32_t has = __ballot_sync(kFull, b[0] >= 0);
      uint32_t base = 0;
      if (lane == 0 && b[0] >= 0) {
        base = atomicAdd(&cnt[b[0]], __popc(has) * kPlaceRun);
      }
      base = __shfl_sync(kFull, base, 0) +
             __popc(has & ((1u << lane) - 1u)) * kPlaceRun;
      if (b[0] >= 0) {
#pragma unroll
        for (int c = 0; c < kPlaceRun; ++c) {
          so[base + c] = static_cast<uint16_t>(e + c);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kPlaceRun; ++c) {
        if (b[c] >= 0) {
          so[atomicAdd(&cnt[b[c]], 1u)] = static_cast<uint16_t>(e + c);
        }
      }
    }
  }
  for (int e = whole_runs + threadIdx.x; e < len; e += kPartThreads) {
    so[atomicAdd(&cnt[bucket_of(sj[e], ranges, log_s)], 1u)] =
        static_cast<uint16_t>(e);
  }
  __syncthreads();
  // the tile's sorted entries, two a thread (the tile is even)
  const int mask = (1 << log_s) - 1;
  for (int p = 2 * threadIdx.x; p < len; p += 2 * kPartThreads) {
    if (p + 1 < len) {
      const uint32_t e2 = *reinterpret_cast<const uint32_t*>(so + p);
      const int j0 = sj[e2 & 0xffffu], j1 = sj[e2 >> 16];
      const uint32_t l2 = static_cast<uint32_t>(j0 < 0 ? 0 : j0 & mask) |
                          static_cast<uint32_t>(j1 < 0 ? 0 : j1 & mask) << 16;
      __stcs(reinterpret_cast<unsigned int*>(sidx + begin + p), l2);
      __stcs(reinterpret_cast<unsigned int*>(soff + begin + p), e2);
    } else {
      const int j = sj[so[p]];
      sidx[begin + p] = static_cast<uint16_t>(j < 0 ? 0 : j & mask);
      soff[begin + p] = so[p];
    }
  }
}

// shared memory of (2): the range (16-byte aligned), then a round's first
// places and exclusive scan of run lengths (kGatherChunk + 1 words)
__host__ __device__ constexpr int gather_range_smem(int elem_bytes,
                                                    int log_s) {
  return elem_bytes << log_s;
}
__host__ __device__ constexpr int gather_smem(int elem_bytes, int log_s) {
  return gather_range_smem(elem_bytes, log_s) + (2 * kGatherChunk + 1) * 4;
}

// (2) a block a bucket r: range r of the source into shared memory, then
// sval[k] = range[sidx[k]] over the bucket's runs in every tile (the fill
// for the last bucket)
template <typename V>
__global__ void __launch_bounds__(kGatherThreads, 2)
    gather_kernel(const V* __restrict__ src, int N, int log_s,
                  const uint16_t* __restrict__ sidx,
                  const uint32_t* __restrict__ starts, int ranges, int tile,
                  int tiles, V fill, V* __restrict__ sval) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  __shared__ uint32_t warp_sums[kGatherWarps];
  V* s = reinterpret_cast<V*>(gsmem);
  const int r = blockIdx.x;
  const bool valid = r < ranges;
  if (valid) {
    const int64_t lo = static_cast<int64_t>(r) << log_s;
    const int len = static_cast<int>(
        N - lo < (1ll << log_s) ? N - lo : (1ll << log_s));
    constexpr int kPer = 16 / static_cast<int>(sizeof(V));
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int nv = len / kPer;
      const uint4* gv = reinterpret_cast<const uint4*>(src + lo);
      uint4* sv = reinterpret_cast<uint4*>(s);
      for (int q0 = threadIdx.x; q0 < nv;
           q0 += kGatherThreads * kGatherUnroll) {
        uint4 v[kGatherUnroll];
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          const int q = q0 + u * kGatherThreads;
          if (q < nv) v[u] = __ldcs(gv + q);
        }
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          const int q = q0 + u * kGatherThreads;
          if (q < nv) sv[q] = v[u];
        }
      }
      done = nv * kPer;
    }
    for (int e = done + threadIdx.x; e < len; e += kGatherThreads) {
      s[e] = src[lo + e];
    }
  }
  // the bucket's runs, kGatherChunk tiles at a time: their first places
  // and an exclusive scan of their lengths in shared memory, then each
  // warp an equal share of the chunk's entries
  uint32_t* tfirst = reinterpret_cast<uint32_t*>(gsmem + gather_range_smem(
      static_cast<int>(sizeof(V)), log_s));
  uint32_t* tpre = tfirst + kGatherChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* row = starts + static_cast<int64_t>(r) * tiles;
  const uint32_t* next = row + tiles;
  constexpr int kPerThread = kGatherChunk / kGatherThreads;
  for (int c0 = 0; c0 < tiles; c0 += kGatherChunk) {
    const int nt = tiles - c0 < kGatherChunk ? tiles - c0 : kGatherChunk;
    for (int q = threadIdx.x; q < kGatherChunk; q += kGatherThreads) {
      const uint32_t f = q < nt ? row[c0 + q] : 0u;
      tfirst[q] = f;
      tpre[q] = q < nt ? next[c0 + q] - f : 0u;
    }
    __syncthreads();
    uint32_t cnt[kPerThread], sum = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      cnt[q] = tpre[threadIdx.x * kPerThread + q];
      sum += cnt[q];
    }
    uint32_t total;
    uint32_t at = block_exclusive_scan<kGatherThreads>(sum, warp_sums,
                                                       &total);
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      tpre[threadIdx.x * kPerThread + q] = at;
      at += cnt[q];
    }
    if (threadIdx.x == 0) tpre[kGatherChunk] = total;
    __syncthreads();
    const uint32_t e0 = static_cast<uint32_t>(
        static_cast<uint64_t>(total) * warp / kGatherWarps);
    const uint32_t e1 = static_cast<uint32_t>(
        static_cast<uint64_t>(total) * (warp + 1) / kGatherWarps);
    // the tile of the warp's first entry: the last whose run starts at or
    // before it
    int ts = 0;
    for (int step = kGatherChunk / 2; step >= 1; step >>= 1) {
      if (ts + step < nt && tpre[ts + step] <= e0) ts += step;
    }
    // windows of 32 tiles, a lane each; each lane finds its entry's run
    // by a binary search over the window's lanes
    for (uint32_t cursor = e0; cursor < e1; ts += 32) {
      const int wt = ts + lane;
      const uint32_t wpre = wt < nt ? tpre[wt] : total;
      const uint32_t wfirst = wt < nt ? tfirst[wt] : 0u;
      const uint32_t wend = ts + 32 < nt ? tpre[ts + 32] : total;
      const uint32_t limit = wend < e1 ? wend : e1;
      for (uint32_t k0 = cursor; k0 < limit; k0 += 32 * kGatherUnroll) {
        int64_t pos[kGatherUnroll];
        uint16_t jl[kGatherUnroll];
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          const uint32_t k = k0 + u * 32 + lane;
          int l = 0;
#pragma unroll
          for (int step = 16; step >= 1; step >>= 1) {
            if (__shfl_sync(kFull, wpre, l + step) <= k) l += step;
          }
          const uint32_t f = __shfl_sync(kFull, wfirst, l);
          const uint32_t p = __shfl_sync(kFull, wpre, l);
          pos[u] = k < limit ? static_cast<int64_t>(c0 + ts + l) * tile + f +
                                   (k - p)
                             : -1;
          jl[u] = (valid && pos[u] >= 0) ? __ldcs(sidx + pos[u]) : 0;
        }
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
          if (pos[u] >= 0) __stcs(sval + pos[u], valid ? s[jl[u]] : fill);
        }
      }
      cursor = limit;
    }
    __syncthreads();
  }
}

// (3) a block a tile: each value to its offset in shared memory, then the
// tile of out, 16 bytes a store where out is 16-byte aligned
template <typename V>
__global__ void __launch_bounds__(kRestoreThreads)
    restore_kernel(const V* __restrict__ sval,
                   const uint16_t* __restrict__ soff, int64_t n, int tile,
                   V* __restrict__ out, int vec16) {
  extern __shared__ __align__(16) unsigned char rsmem[];
  V* s = reinterpret_cast<V*>(rsmem);
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * tile;
  const int len = static_cast<int>(n - begin < tile ? n - begin : tile);
  // eight entries a thread a round: one 16-byte load of offsets, 32 or 64
  // bytes of values (the tile is a multiple of 8, so both are aligned)
  constexpr int kPer = 16 / static_cast<int>(sizeof(V));
  const int whole = len / 8 * 8;
  for (int p = 8 * threadIdx.x; p < whole; p += 8 * kRestoreThreads) {
    const uint4 o = __ldcs(reinterpret_cast<const uint4*>(soff + begin + p));
    uint4 q[8 / kPer];
#pragma unroll
    for (int c = 0; c < 8 / kPer; ++c) {
      q[c] = __ldcs(reinterpret_cast<const uint4*>(sval + begin + p) + c);
    }
    const uint16_t* oo = reinterpret_cast<const uint16_t*>(&o);
    const V* vv = reinterpret_cast<const V*>(q);
#pragma unroll
    for (int c = 0; c < 8; ++c) s[oo[c]] = vv[c];
  }
  for (int p = whole + threadIdx.x; p < len; p += kRestoreThreads) {
    s[soff[begin + p]] = sval[begin + p];
  }
  __syncthreads();
  V* g = out + begin;
  int done = 0;
  if (vec16) {
    const int nv = len / kPer;
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    uint4* gv = reinterpret_cast<uint4*>(g);
    for (int q = threadIdx.x; q < nv; q += kRestoreThreads) gv[q] = sv[q];
    done = nv * kPer;
  }
  for (int e = done + threadIdx.x; e < len; e += kRestoreThreads) g[e] = s[e];
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  void* out;
  const void* src;
  int N;
  int64_t n;
  unsigned long long fill_bits;
  int log_s, ranges, tile, tiles;
  uint32_t* starts;
  uint16_t* sidx;
  uint16_t* soff;
  void* sval;
  cudaStream_t st;
};

template <typename P>
int partition(const Args& a, const P& ix) {
  static int configured[kMaxDevices] = {};
  const int smem = partition_smem(a.tile, a.ranges + 1);
  int rc = allow_smem(reinterpret_cast<const void*>(&partition_kernel<P>),
                      smem, configured);
  if (rc != 0) return rc;
  partition_kernel<P><<<static_cast<unsigned>(a.tiles), kPartThreads, smem,
                        a.st>>>(ix, a.n, a.log_s, a.ranges, a.tile, a.tiles,
                                a.starts, a.sidx, a.soff);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int partition_coords(const Args& a, const void* ca, const void* cb,
                     long long base, long long s0, long long s1, int d0,
                     int d1) {
  return partition(a, CoordPair<T>{static_cast<const T*>(ca),
                                   static_cast<const T*>(cb), base, s0, s1,
                                   d0, d1});
}

// the cut's limits (see vex_gather_ranges)
bool takes(int elem_bytes, int N, int64_t n, int log_s, int ranges,
           int tile, int tiles) {
  return (elem_bytes == 4 || elem_bytes == 8) && N > 0 && n > 0 &&
         log_s >= 4 && log_s <= kMaxLogS &&
         gather_smem(elem_bytes, log_s) <= kMaxSmem && ranges > 0 &&
         ranges <= kMaxRanges &&
         (static_cast<int64_t>(ranges) << log_s) >= N && tile > 0 &&
         tile <= kMaxTile && tile % 8 == 0 && tile * elem_bytes <= kMaxSmem &&
         partition_smem(tile, ranges + 1) <= kMaxSmem && tiles > 0 &&
         static_cast<int64_t>(tiles) * tile >= n;
}

template <typename V>
int gather_restore(const Args& a) {
  static int configured[kMaxDevices] = {};
  const int smem = gather_smem(static_cast<int>(sizeof(V)), a.log_s);
  int rc = allow_smem(reinterpret_cast<const void*>(&gather_kernel<V>), smem,
                      configured);
  if (rc != 0) return rc;
  gather_kernel<V><<<static_cast<unsigned>(a.ranges + 1), kGatherThreads,
                     smem, a.st>>>(
      static_cast<const V*>(a.src), a.N, a.log_s, a.sidx, a.starts, a.ranges,
      a.tile, a.tiles, static_cast<V>(a.fill_bits), static_cast<V*>(a.sval));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  static int configured_r[kMaxDevices] = {};
  const int rsmem = a.tile * static_cast<int>(sizeof(V));
  rc = allow_smem(reinterpret_cast<const void*>(&restore_kernel<V>), rsmem,
                  configured_r);
  if (rc != 0) return rc;
  const int vec16 = (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  restore_kernel<V><<<static_cast<unsigned>(a.tiles), kRestoreThreads,
                      rsmem, a.st>>>(static_cast<const V*>(a.sval), a.soff,
                                     a.n, a.tile, static_cast<V*>(a.out),
                                     vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[i] = src[j], j = int32(idx[i]) wrapped once by +N, the fill where j
// is still out of range.  out: n elements of elem_bytes (4 or 8); src: N
// elements of the same width; idx: n indices (i32, or i64 when idx64).
// Tiles of `tile` destinations (a multiple of 8, at most 2^15, its values
// at most 227 KB), source ranges of 2^log_s elements (at most 2^16 and
// 227 KB; `ranges` of them, at most kMaxRanges).  Scratch: starts
// ((ranges + 2) x tiles u32), sidx and soff (n u16 each, soff 16-byte
// aligned), sval (n elements, 16-byte aligned).
int vex_gather_ranges(void* out, const void* src, int elem_bytes, int N,
                      const void* idx, int idx64, int64_t n,
                      unsigned long long fill_bits, int log_s, int ranges,
                      int tile, int tiles, void* starts, void* sidx,
                      void* soff, void* sval, void* stream) {
  if (!takes(elem_bytes, N, n, log_s, ranges, tile, tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{out, src, N, n, fill_bits, log_s, ranges, tile, tiles,
         static_cast<uint32_t*>(starts), static_cast<uint16_t*>(sidx),
         static_cast<uint16_t*>(soff), sval,
         static_cast<cudaStream_t>(stream)};
  // i64 indices as long long, the type CUDA's load intrinsics name
  int rc = idx64 ? partition(a, IndexArray<long long>{
                                    static_cast<const long long*>(idx), N})
                 : partition(a, IndexArray<int>{
                                    static_cast<const int*>(idx), N});
  if (rc != 0) return rc;
  return elem_bytes == 4 ? gather_restore<unsigned int>(a)
                         : gather_restore<unsigned long long>(a);
}

// The fused variant: out[i] = src[j], j = base + c0 * s0 + c1 * s1 from
// the coordinate arrays ca and cb (n elements each, of coord_type: 0 f32,
// 1 f64, 2 i32, 3 i64), each coordinate clamped into [0, d0) and [0, d1)
// (CoordPair); base + (d0 - 1) s0 + (d1 - 1) s1 < N.  The cut and the
// scratch as vex_gather_ranges.
int vex_gather_coords(void* out, const void* src, int elem_bytes, int N,
                      const void* ca, const void* cb, int coord_type,
                      long long base, long long s0, long long s1, int d0,
                      int d1, int64_t n, unsigned long long fill_bits,
                      int log_s, int ranges, int tile, int tiles,
                      void* starts, void* sidx, void* soff, void* sval,
                      void* stream) {
  if (!takes(elem_bytes, N, n, log_s, ranges, tile, tiles) || d0 <= 0 ||
      d1 <= 0 || base < 0 || s0 < 0 || s1 < 0 ||
      base + (d0 - 1) * s0 + (d1 - 1) * s1 >= N || coord_type < 0 ||
      coord_type > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{out, src, N, n, fill_bits, log_s, ranges, tile, tiles,
         static_cast<uint32_t*>(starts), static_cast<uint16_t*>(sidx),
         static_cast<uint16_t*>(soff), sval,
         static_cast<cudaStream_t>(stream)};
  int rc;
  switch (coord_type) {
    case 0:
      rc = partition_coords<float>(a, ca, cb, base, s0, s1, d0, d1);
      break;
    case 1:
      rc = partition_coords<double>(a, ca, cb, base, s0, s1, d0, d1);
      break;
    case 2:
      rc = partition_coords<int>(a, ca, cb, base, s0, s1, d0, d1);
      break;
    default:
      rc = partition_coords<long long>(a, ca, cb, base, s0, s1, d0, d1);
  }
  if (rc != 0) return rc;
  return elem_bytes == 4 ? gather_restore<unsigned int>(a)
                         : gather_restore<unsigned long long>(a);
}

// The most ranges the kernels take.
int vex_gather_max_ranges(void) { return kMaxRanges; }

const char* vex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
