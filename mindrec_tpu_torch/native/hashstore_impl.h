// Host-side hash embedding store implementation, included by
// hashstore.cc (ctypes C ABI).  A copy of mindrec_tpu/native/
// hashstore_impl.h.  See hashstore.cc header for semantics.
//
// One change: the bucket table grows.  It holds every key seen, pending
// ones included, and the reference sizes it once at 2 x capacity: a
// stream with more distinct keys than that fills it, after which every
// new key probes the whole table and is refused, admitted or forced.
// Here a new key that would fill more than 3/4 of the buckets (entries
// and tombstones) first rebuilds the table, doubled until it is at most
// half full.  Below that load the store is bucket for bucket the
// reference's (the same slots, freed order and items order).
#ifndef MINDREC_HASHSTORE_IMPL_H_
#define MINDREC_HASHSTORE_IMPL_H_

#include <cstdint>
#include <cstring>
#include <vector>

namespace mindrec {


struct Entry {
  int64_t key;
  int64_t slot;       // >=0 admitted; -1 pending admission
  int64_t seen;       // distinct steps seen (pre-admission)
  int64_t seen_step;  // last step counted toward `seen`
  int64_t last;       // last touched step (for eviction)
  uint8_t state;      // 0 empty, 1 used, 2 tombstone
};

class HashStore {
 public:
  HashStore(int64_t capacity, int64_t permit, int64_t evict)
      : capacity_(capacity), permit_(permit), evict_(evict) {
    nbuckets_ = 16;
    while (nbuckets_ < capacity * 2) nbuckets_ <<= 1;
    table_.assign(nbuckets_, Entry{0, 0, 0, 0, 0, 0});
    free_.reserve(capacity);
    for (int64_t s = capacity - 1; s >= 0; --s) free_.push_back(s);
  }

  int64_t size() const { return size_; }

  void LookupOrInsert(const int64_t* keys, int64_t n, int64_t* out, bool force) {
    ++step_;
    for (int64_t i = 0; i < n; ++i) {
      out[i] = Probe(keys[i], force);
    }
  }

  int64_t Evict(int64_t* freed_slots) {
    int64_t n_freed = 0;
    for (auto& e : table_) {
      if (e.state == 1 && e.slot >= 0 && step_ - e.last >= evict_) {
        freed_slots[n_freed++] = e.slot;
        free_.push_back(e.slot);
        e.state = 2;  // tombstone
        --size_;
      }
    }
    return n_freed;
  }

  void Erase(const int64_t* keys, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t idx = Hash(keys[i]);
      for (uint64_t probes = 0; probes < (uint64_t)nbuckets_; ++probes) {
        Entry& e = table_[idx];
        if (e.state == 0) break;
        if (e.state == 1 && e.key == keys[i]) {
          if (e.slot >= 0) {
            free_.push_back(e.slot);
            --size_;
          }
          e.state = 2;
          break;
        }
        idx = (idx + 1) & (nbuckets_ - 1);
      }
    }
  }

  int64_t Items(int64_t* keys, int64_t* slots) const {
    int64_t n = 0;
    for (const auto& e : table_) {
      if (e.state == 1 && e.slot >= 0) {
        keys[n] = e.key;
        slots[n] = e.slot;
        ++n;
      }
    }
    return n;
  }

 private:
  uint64_t Hash(int64_t key) const {
    // splitmix64 finalizer — good avalanche for sequential ids
    uint64_t x = (uint64_t)key;
    x ^= x >> 30;
    x *= 0xbf58476d1ce4e5b9ULL;
    x ^= x >> 27;
    x *= 0x94d049bb133111ebULL;
    x ^= x >> 31;
    return x & (uint64_t)(nbuckets_ - 1);
  }

  int64_t Probe(int64_t key, bool force) {
    uint64_t idx = Hash(key);
    int64_t first_tomb = -1;
    for (uint64_t probes = 0; probes < (uint64_t)nbuckets_; ++probes) {
      Entry& e = table_[idx];
      if (e.state == 0) {
        if (first_tomb >= 0) return InsertAt(first_tomb, key, force);
        if ((used_ + 1) * 4 > nbuckets_ * 3) {
          Rehash();
          return Probe(key, force);
        }
        ++used_;
        return InsertAt((int64_t)idx, key, force);
      }
      if (e.state == 2) {
        if (first_tomb < 0) first_tomb = (int64_t)idx;
      } else if (e.key == key) {
        if (e.slot >= 0) {  // admitted
          e.last = step_;
          return e.slot;
        }
        // pending admission
        if (e.seen_step != step_) {
          ++e.seen;
          e.seen_step = step_;
        }
        if (force || e.seen >= permit_) {
          if (free_.empty()) return -1;  // arena full
          e.slot = free_.back();
          free_.pop_back();
          e.last = step_;
          ++size_;
          return e.slot;
        }
        return -1;
      }
      idx = (idx + 1) & (nbuckets_ - 1);
    }
    return -1;  // table full
  }

  int64_t InsertAt(int64_t idx, int64_t key, bool force) {
    Entry& e = table_[idx];
    e.key = key;
    e.state = 1;
    e.seen = 1;
    e.seen_step = step_;
    e.last = step_;
    if (force || e.seen >= permit_) {
      if (free_.empty()) {
        e.slot = -1;
        return -1;
      }
      e.slot = free_.back();
      free_.pop_back();
      ++size_;
      return e.slot;
    }
    e.slot = -1;
    return -1;
  }

  // Rebuild without tombstones, doubled until at most half full; entries
  // keep every field (seen counts, clocks, slots).
  void Rehash() {
    int64_t live = 0;
    for (const auto& e : table_) live += e.state == 1;
    int64_t nb = nbuckets_;
    while ((live + 1) * 2 > nb) nb <<= 1;
    std::vector<Entry> old;
    old.swap(table_);
    nbuckets_ = nb;
    table_.assign(nbuckets_, Entry{0, 0, 0, 0, 0, 0});
    for (const auto& e : old) {
      if (e.state != 1) continue;
      uint64_t idx = Hash(e.key);
      while (table_[idx].state != 0) idx = (idx + 1) & (nbuckets_ - 1);
      table_[idx] = e;
    }
    used_ = live;
  }

  int64_t capacity_, permit_, evict_;
  int64_t nbuckets_ = 0;
  int64_t used_ = 0;  // buckets not empty: entries and tombstones
  int64_t step_ = 0;
  int64_t size_ = 0;
  std::vector<Entry> table_;
  std::vector<int64_t> free_;
};

}  // namespace mindrec

#endif  // MINDREC_HASHSTORE_IMPL_H_
