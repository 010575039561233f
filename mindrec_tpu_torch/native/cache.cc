// Device-cache manager for the hierarchical embedding cache.
//
// A copy of the JAX package's native/cache.cc (the port keeps its own and
// builds it with g++ at first use: ops/cache.py).  The host-side
// equivalent of the reference's engine-side embedding cache
// (control surface: vocab_cache_size in nn.EmbeddingLookup /
// HashEmbeddingLookup, mindspore_rec/ops/embedding.py:163-182; tiers
// described in README.md:146-151): the device HBM holds a fixed arena
// of `capacity` rows; this host-side manager maps huge feature ids ->
// arena slots with LRU replacement and reports, per batch, which rows
// to fetch from the host tier and which dirty rows to write back.
//
// Single-threaded per instance (driven by the input pipeline).
// C ABI for ctypes.

#include <cstdint>
#include <climits>
#include <cstring>
#include <vector>

namespace {


// Flat open-addressing int64->slot map (linear probe, power-of-two
// table, tombstones with rebuild-on-pressure).  The LRU's map holds at
// most `capacity` live entries and sees one find per batch position —
// the std::unordered_map it replaces spent ~45 ns/probe in pointer
// chasing; a flat table probes one cache line (~12 ns).  Eviction
// churn leaves tombstones; when they exceed half the live bound the
// table rebuilds from scratch in O(table) (amortized negligible).
class FlatMap {
 public:
  explicit FlatMap(int64_t max_entries) : max_entries_(max_entries) {
    int64_t want = max_entries * 2;  // load factor <= 0.5 (+tombstones
                                     // bounded by the rebuild trigger)
    cap_ = 64;
    while (cap_ < want) cap_ <<= 1;
    mask_ = cap_ - 1;
    keys_.assign(cap_, kEmpty);
    vals_.resize(cap_);
  }

  static constexpr int64_t kEmpty = INT64_MIN;
  static constexpr int64_t kTomb = INT64_MIN + 1;

  // Key-domain contract: any int64 feature id is a valid key.  The two
  // sentinel VALUES (kEmpty/kTomb) cannot live inside the probe table,
  // so keys equal to them are held in two exact side slots instead of
  // silently corrupting the map (negative ids do occur, e.g. in the
  // tfrecord golden fixtures).
  static int SideIdx(int64_t key) {
    return key == kEmpty ? 0 : (key == kTomb ? 1 : -1);
  }

  // -1 if absent
  int64_t Find(int64_t key) const {
    const int s = SideIdx(key);
    if (s >= 0) return side_val_[s];
    int64_t i = Hash(key);
    for (;;) {
      const int64_t k = keys_[i];
      if (k == key) return vals_[i];
      if (k == kEmpty) return -1;
      i = (i + 1) & mask_;
    }
  }

  void Insert(int64_t key, int64_t val) {
    const int s = SideIdx(key);
    if (s >= 0) {
      if (side_val_[s] < 0) ++size_;
      side_val_[s] = val;
      return;
    }
    if (tombs_ > max_entries_ / 2) Rebuild();
    int64_t i = Hash(key);
    int64_t first_tomb = -1;
    // probe to the first kEmpty looking for the key (a tombstone may
    // hide a live duplicate later in the chain); reuse the first
    // tombstone seen only once the key is known absent
    for (;;) {
      const int64_t k = keys_[i];
      if (k == key) {  // overwrite (not used by the LRU, kept for safety)
        vals_[i] = val;
        return;
      }
      if (k == kTomb) {
        if (first_tomb < 0) first_tomb = i;
      } else if (k == kEmpty) {
        if (first_tomb >= 0) {
          i = first_tomb;
          --tombs_;
        }
        keys_[i] = key;
        vals_[i] = val;
        ++size_;
        return;
      }
      i = (i + 1) & mask_;
    }
  }

  void Erase(int64_t key) {
    const int s = SideIdx(key);
    if (s >= 0) {
      if (side_val_[s] >= 0) --size_;
      side_val_[s] = -1;
      return;
    }
    int64_t i = Hash(key);
    for (;;) {
      const int64_t k = keys_[i];
      if (k == key) {
        keys_[i] = kTomb;
        ++tombs_;
        --size_;
        return;
      }
      if (k == kEmpty) return;
      i = (i + 1) & mask_;
    }
  }

  int64_t size() const { return size_; }

 private:
  int64_t Hash(int64_t key) const {
    // splitmix64 finalizer
    uint64_t x = (uint64_t)key + 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return (int64_t)((x ^ (x >> 31)) & (uint64_t)mask_);
  }

  void Rebuild() {
    std::vector<int64_t> old_keys;
    std::vector<int64_t> old_vals;
    old_keys.swap(keys_);
    old_vals.swap(vals_);
    keys_.assign(cap_, kEmpty);
    vals_.assign(cap_, 0);
    tombs_ = 0;
    // the side slots stay live through a rebuild (the reference's copy
    // resets size_ to 0 here and so drops them from size())
    size_ = (side_val_[0] >= 0) + (side_val_[1] >= 0);
    for (int64_t i = 0; i < cap_; ++i) {
      const int64_t k = old_keys[i];
      if (k != kEmpty && k != kTomb) Insert(k, old_vals[i]);
    }
  }

  int64_t max_entries_, cap_, mask_;
  int64_t size_ = 0, tombs_ = 0;
  int64_t side_val_[2] = {-1, -1};  // exact slots for sentinel-valued keys
  std::vector<int64_t> keys_, vals_;
};

class LruCache {
 public:
  explicit LruCache(int64_t capacity) : cap_(capacity), map_(capacity) {
    prev_.resize(capacity, -1);
    next_.resize(capacity, -1);
    slot_key_.resize(capacity, -1);
    // all slots start free
    free_.reserve(capacity);
    for (int64_t s = capacity - 1; s >= 0; --s) free_.push_back(s);
  }

  // Process one batch of ids. Outputs:
  //   slots[n]       — arena slot for every id
  //   load_ids/load_slots[<=n]   — rows the host must push to the arena
  //   evict_ids/evict_slots[<=n] — dirty rows to read back first
  // Returns number of misses (= len(load)); n_evict via out param.
  int64_t Lookup(const int64_t* ids, int64_t n, int64_t* slots,
                 int64_t* load_ids, int64_t* load_slots, int64_t* evict_ids,
                 int64_t* evict_slots, int64_t* n_evict_out) {
    ++stamp_;
    // Pass 0: pin every id of this batch that is already resident —
    // including ones appearing AFTER a miss in the same batch.  Without
    // this an earlier miss can evict a later batch id, which then
    // reloads a stale row from the tier and silently loses its training
    // updates (the reference's known eviction-bug class, RELEASE.md:6).
    // The found slot is memoized so the resolve pass only re-probes the
    // map for ids that were absent (possibly inserted by an earlier
    // duplicate miss in this same batch) — one hash probe per hit, not
    // two (~97% of a cache-friendly batch).
    scratch_.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t s = map_.Find(ids[i]);
      if (s >= 0) pin_stamp_resize(s);
      scratch_[i] = s;
    }
    // Pass 1: resolve slots; misses allocate (free list, then unpinned LRU).
    int64_t n_load = 0, n_evict = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t key = ids[i];
      int64_t s0 = scratch_[i];
      if (s0 < 0) s0 = map_.Find(key);
      if (s0 >= 0) {
        Touch(s0);
        pin_stamp_resize(s0);
        slots[i] = s0;
        continue;
      }
      // miss: need a slot
      int64_t s;
      if (!free_.empty()) {
        s = free_.back();
        free_.pop_back();
      } else {
        s = EvictLru();
        if (s < 0) { slots[i] = -1; continue; }  // everything pinned
        evict_ids[n_evict] = slot_key_[s];
        evict_slots[n_evict] = s;
        ++n_evict;
        map_.Erase(slot_key_[s]);
      }
      map_.Insert(key, s);
      slot_key_[s] = key;
      PushFront(s);
      pin_stamp_resize(s);
      load_ids[n_load] = key;
      load_slots[n_load] = s;
      ++n_load;
      slots[i] = s;
    }
    *n_evict_out = n_evict;
    return n_load;
  }

  int64_t size() const { return (int64_t)map_.size(); }

 private:
  void pin_stamp_resize(int64_t s) {
    if ((int64_t)pin_.size() < cap_) pin_.resize(cap_, 0);
    pin_[s] = stamp_;
  }

  void Unlink(int64_t s) {
    if (prev_[s] >= 0) next_[prev_[s]] = next_[s];
    if (next_[s] >= 0) prev_[next_[s]] = prev_[s];
    if (head_ == s) head_ = next_[s];
    if (tail_ == s) tail_ = prev_[s];
    prev_[s] = next_[s] = -1;
  }

  void PushFront(int64_t s) {
    prev_[s] = -1;
    next_[s] = head_;
    if (head_ >= 0) prev_[head_] = s;
    head_ = s;
    if (tail_ < 0) tail_ = s;
  }

  void Touch(int64_t s) {
    Unlink(s);
    PushFront(s);
  }

  int64_t EvictLru() {
    int64_t s = tail_;
    while (s >= 0 && (int64_t)pin_.size() == cap_ && pin_[s] == stamp_)
      s = prev_[s];
    if (s < 0) return -1;
    Unlink(s);
    return s;
  }

  int64_t cap_;
  int64_t head_ = -1, tail_ = -1;
  int64_t stamp_ = 0;
  FlatMap map_;
  std::vector<int64_t> prev_, next_, slot_key_;
  std::vector<int64_t> pin_;
  std::vector<int64_t> free_;
  std::vector<int64_t> scratch_;  // per-batch pass-0 slot memo
};

}  // namespace

extern "C" {

void* lru_create(int64_t capacity) { return new LruCache(capacity); }
void lru_destroy(void* h) { delete static_cast<LruCache*>(h); }
int64_t lru_size(void* h) { return static_cast<LruCache*>(h)->size(); }

int64_t lru_lookup(void* h, const int64_t* ids, int64_t n, int64_t* slots,
                   int64_t* load_ids, int64_t* load_slots, int64_t* evict_ids,
                   int64_t* evict_slots, int64_t* n_evict_out) {
  return static_cast<LruCache*>(h)->Lookup(ids, n, slots, load_ids, load_slots,
                                           evict_ids, evict_slots, n_evict_out);
}

}  // extern "C"
