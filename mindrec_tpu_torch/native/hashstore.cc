// Host-side hash embedding store — the native core of the framework's
// MapParameter-equivalent (see hashstore.py for semantics; reference
// control surface: mindspore_rec/ops/embedding.py:136-149).
//
// A copy of the JAX package's native/hashstore.cc (the port keeps its own and
// builds it with g++ at first use: native/hashstore.py).
//
// Open-addressing (linear probing, power-of-two buckets) int64-key table
// mapping feature keys -> dense arena slots, with:
//   * admission: a key gets a slot only after being seen in
//     >= permit_threshold distinct steps;
//   * eviction: keys idle for >= evict_threshold steps are erased and
//     their slots recycled (explicit hs_evict call);
//   * a free-slot stack bounded by the arena capacity.
//
// Exposed as a C ABI for ctypes. Single-writer per store instance; the
// training loop calls lookup_or_insert once per batch (one "step").

#include <cstdint>
#include <cstring>
#include <vector>

#include "hashstore_impl.h"

using mindrec::HashStore;


extern "C" {

void* hs_create(int64_t capacity, int64_t permit, int64_t evict) {
  return new HashStore(capacity, permit, evict);
}

void hs_destroy(void* h) { delete static_cast<HashStore*>(h); }

int64_t hs_size(void* h) { return static_cast<HashStore*>(h)->size(); }

void hs_lookup_or_insert(void* h, const int64_t* keys, int64_t n, int64_t* out,
                         int force) {
  static_cast<HashStore*>(h)->LookupOrInsert(keys, n, out, force != 0);
}

int64_t hs_evict(void* h, int64_t* freed) {
  return static_cast<HashStore*>(h)->Evict(freed);
}

void hs_erase(void* h, const int64_t* keys, int64_t n) {
  static_cast<HashStore*>(h)->Erase(keys, n);
}

int64_t hs_items(void* h, int64_t* keys, int64_t* slots) {
  return static_cast<HashStore*>(h)->Items(keys, slots);
}

}  // extern "C"
