// reduce_by_key and the keyed scans over 4-byte values (f32, i32):
// an instantiation of by_key.cuh, which holds the kernel and its design
// note, in a library of its own (one a carry width, so that the builds run
// at once).

#include "by_key.cuh"

extern "C" int vex_by_key(int dtype, int mono, int mode, int nkeys,
                          long long codes, void* const* ptrs, const void* x,
                          void* y, int64_t n, unsigned long long init,
                          void* count, void* status, void* values,
                          void* counts, void* lasts, void* counters,
                          void* stream) {
  return by_key_entry<float, int32_t>(
      dtype, mono, mode, nkeys, codes, ptrs, x, y, n, init, count, status,
      values, counts, lasts, counters, stream);
}
