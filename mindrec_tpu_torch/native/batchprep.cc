// Host-side batch prep: stable radix sort of (id, position) pairs +
// unique extraction, the C++ core of make_batch_sort.
//
// A copy of mindrec_tpu/native/batchprep.cc (the port keeps its own, and
// builds it with g++ at first use: native/batchprep.py).  The per-batch
// prep the sparse train step needs (sort positions by id, inverse
// permutation, padded unique ids, position->unique maps) is one C call
// so the input pipeline can overlap it with the device step from a
// plain Python thread: ctypes releases the GIL for the call's duration.
//
// Cost model: an LSD radix sort over the live bit-width of the ids
// with index payload packed into the key's low 32 bits (ties keep
// insertion order with no distinct stable-partition step).  The digit
// width adapts so ranges up to 24 bits (criteo's 5.86M vocab is 23)
// sort in TWO passes; the scatter-write output pass skips any output
// the caller passed as null (the train step never reads inv or
// sorted_ids when the full unique metadata is precomputed).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// scratch persists across calls: the prep pool calls this at step rate
// and fresh 10 MB allocations would page-fault every batch.
thread_local std::vector<uint64_t> t_a;
thread_local std::vector<uint64_t> t_b;

}  // namespace

extern "C" {

// ids[n] -> optional sorted_ids[n], perm[n], optional inv[n],
// uq[uq_len] (sentinel padded), uidx[n] (batch position -> unique
// index), uidx_sorted[n].  Null output pointers are skipped.
// Returns the number of distinct ids (even if > uq_len, so the caller
// can detect bucket overflow; uq then holds the first uq_len uniques).
// Negative ids are supported via a min-bias (the dynamic-hash path
// reserves -1/-2, but translated slots are non-negative in practice).
int64_t mrec_batch_prep_i32(const int32_t* ids, int64_t n,
                            int32_t* sorted_ids, int32_t* perm, int32_t* inv,
                            int32_t* uq, int32_t* uidx, int32_t* uidx_sorted,
                            int64_t uq_len, int32_t uq_fill) {
  if (n <= 0) {
    for (int64_t i = 0; i < uq_len; ++i) uq[i] = uq_fill;
    return 0;
  }
  int32_t mn = ids[0], mx = ids[0];
  for (int64_t i = 1; i < n; ++i) {
    const int32_t v = ids[i];
    if (v < mn) mn = v;
    if (v > mx) mx = v;
  }
  const uint32_t range = static_cast<uint32_t>(mx) - static_cast<uint32_t>(mn);
  int bits = 0;
  while ((range >> bits) != 0 && bits < 32) ++bits;
  // digit width: 2 passes up to 24 bits (12-bit digits keep the 4096
  // scatter streams' active cache lines ~256 KB); 11-bit digits beyond.
  int digit_bits;
  if (bits <= 12) digit_bits = bits > 0 ? bits : 1;
  else if (bits <= 24) digit_bits = (bits + 1) / 2;
  else digit_bits = 11;
  const int radix = 1 << digit_bits;
  const int passes = (bits + digit_bits - 1) / digit_bits;

  if (t_a.size() < static_cast<size_t>(n)) t_a.resize(n);
  uint64_t* a = t_a.data();
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key = static_cast<uint32_t>(ids[i]) - static_cast<uint32_t>(mn);
    a[i] = (key << 32) | static_cast<uint32_t>(i);
  }
  if (passes > 0) {
    if (t_b.size() < static_cast<size_t>(n)) t_b.resize(n);
    uint64_t* src = a;
    uint64_t* dst = t_b.data();
    std::vector<int64_t> hist(radix);
    for (int p = 0; p < passes; ++p) {
      const int shift = 32 + p * digit_bits;
      std::memset(hist.data(), 0, sizeof(int64_t) * radix);
      for (int64_t i = 0; i < n; ++i)
        ++hist[(src[i] >> shift) & (radix - 1)];
      int64_t sum = 0;
      for (int d = 0; d < radix; ++d) {
        const int64_t c = hist[d];
        hist[d] = sum;
        sum += c;
      }
      for (int64_t i = 0; i < n; ++i)
        dst[hist[(src[i] >> shift) & (radix - 1)]++] = src[i];
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
    a = src;
  }

  // one fused output pass: sorted ids, perm, inv, unique run starts.
  // The random-address writes (inv[pos], uidx[pos]) dominate this pass;
  // callers that don't need inv pass null and save ~1/3 of it.
  int64_t nu = 0;
  int32_t prev = 0;
  const uint32_t bias = static_cast<uint32_t>(mn);
  if (inv == nullptr && sorted_ids == nullptr) {
    for (int64_t s = 0; s < n; ++s) {
      const uint64_t e = a[s];
      const int32_t pos = static_cast<int32_t>(e & 0xffffffffu);
      const int32_t id =
          static_cast<int32_t>(static_cast<uint32_t>(e >> 32) + bias);
      if (s == 0 || id != prev) {
        if (nu < uq_len) uq[nu] = id;
        ++nu;
      }
      prev = id;
      perm[s] = pos;
      const int32_t u = static_cast<int32_t>(nu - 1);
      uidx_sorted[s] = u;
      uidx[pos] = u;
    }
  } else {
    for (int64_t s = 0; s < n; ++s) {
      const uint64_t e = a[s];
      const int32_t pos = static_cast<int32_t>(e & 0xffffffffu);
      const int32_t id =
          static_cast<int32_t>(static_cast<uint32_t>(e >> 32) + bias);
      if (s == 0 || id != prev) {
        if (nu < uq_len) uq[nu] = id;
        ++nu;
      }
      prev = id;
      if (sorted_ids != nullptr) sorted_ids[s] = id;
      perm[s] = pos;
      if (inv != nullptr) inv[pos] = static_cast<int32_t>(s);
      const int32_t u = static_cast<int32_t>(nu - 1);
      uidx_sorted[s] = u;
      uidx[pos] = u;
    }
  }
  for (int64_t i = nu < uq_len ? nu : uq_len; i < uq_len; ++i) uq[i] = uq_fill;
  return nu;
}

}  // extern "C"
