// Native host-DRAM KV store: partitioned hash map for embedding vectors.
//
// A copy of the JAX package's native/kvstore.cpp, built for the PyTorch port
// by native/kvstore.py (g++ at first use; the port never loads the JAX
// package's library). Counterpart of the reference's volatile-database
// hash-map backends (hash_map / parallel_hash_map: partitions = min(cores,16),
// per-partition allocation chunks, overflow margin/policy/resolution —
// reference docs/hierarchical_parameter_server.md:403-512), exposed to Python
// over a C ABI (ctypes).
//
// Design:
//   - open-addressing (linear probe) int64 -> row-index table per partition,
//     power-of-two capacity, max load factor 0.6, tombstone-free (backshift
//     deletion);
//   - row arena per partition (float32, dim columns), grown geometrically;
//   - per-partition shared_mutex: concurrent bulk queries, exclusive inserts;
//   - partition chosen by key low bits (reference docs/architecture.md:131);
//   - eviction policies: 0=random, 1=least-used (access tick), 2=oldest
//     (insert tick), applied per partition when count exceeds
//     margin/num_partitions, down to resolution_target
//     (reference docs/hierarchical_parameter_server.md:460-487);
//   - bulk ops parallelized across partitions with std::thread (bounded by
//     hardware_concurrency, mirroring reference thread_pool.cpp:28-35).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;

struct Partition {
  int dim;
  // hash table: slot -> key + row
  std::vector<int64_t> slot_key;
  std::vector<uint32_t> slot_row;
  size_t mask = 0;
  size_t count = 0;
  // row arena
  std::vector<float> rows;
  std::vector<int64_t> row_key;       // reverse map row -> key
  std::vector<uint64_t> last_used;    // access tick per row
  std::vector<uint64_t> inserted_at;  // insert tick per row
  uint64_t tick = 0;
  mutable std::shared_mutex mu;

  explicit Partition(int d) : dim(d) { rehash(1024); }

  void rehash(size_t new_cap) {
    std::vector<int64_t> old_keys = std::move(slot_key);
    std::vector<uint32_t> old_rows = std::move(slot_row);
    slot_key.assign(new_cap, kEmpty);
    slot_row.assign(new_cap, 0);
    mask = new_cap - 1;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] != kEmpty) place(old_keys[i], old_rows[i]);
    }
  }

  static inline size_t hash_key(int64_t k) {
    uint64_t x = static_cast<uint64_t>(k);
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return static_cast<size_t>(x);
  }

  inline void place(int64_t key, uint32_t row) {
    size_t i = hash_key(key) & mask;
    while (slot_key[i] != kEmpty) i = (i + 1) & mask;
    slot_key[i] = key;
    slot_row[i] = row;
  }

  // returns slot index or SIZE_MAX
  inline size_t find(int64_t key) const {
    size_t i = hash_key(key) & mask;
    while (true) {
      if (slot_key[i] == key) return i;
      if (slot_key[i] == kEmpty) return SIZE_MAX;
      i = (i + 1) & mask;
    }
  }

  void maybe_grow() {
    if (count * 5 >= (mask + 1) * 3) rehash((mask + 1) * 2);  // load > 0.6
  }

  // backshift deletion keeps probes correct without tombstones
  void erase_slot(size_t i) {
    slot_key[i] = kEmpty;
    size_t j = i;
    while (true) {
      j = (j + 1) & mask;
      if (slot_key[j] == kEmpty) break;
      size_t ideal = hash_key(slot_key[j]) & mask;
      // can slot j's entry move into the hole at i?
      bool wraps = (ideal <= i) == (i <= j);
      if ((i < j) ? (ideal <= i || ideal > j) : (ideal <= i && ideal > j)) {
        slot_key[i] = slot_key[j];
        slot_row[i] = slot_row[j];
        slot_key[j] = kEmpty;
        i = j;
      }
      (void)wraps;
    }
  }

  void erase_row(uint32_t row) {
    // move last row into the hole
    uint32_t last = static_cast<uint32_t>(row_key.size() - 1);
    int64_t victim_key = row_key[row];
    size_t vslot = find(victim_key);
    if (vslot != SIZE_MAX) erase_slot(vslot);
    if (row != last) {
      std::memcpy(&rows[size_t(row) * dim], &rows[size_t(last) * dim],
                  sizeof(float) * dim);
      row_key[row] = row_key[last];
      last_used[row] = last_used[last];
      inserted_at[row] = inserted_at[last];
      size_t mslot = find(row_key[row]);
      if (mslot != SIZE_MAX) slot_row[mslot] = row;
    }
    rows.resize(size_t(last) * dim);
    row_key.pop_back();
    last_used.pop_back();
    inserted_at.pop_back();
    --count;
  }
};

struct Store {
  int dim;
  int num_partitions;
  uint64_t overflow_margin;
  int overflow_policy;  // 0 random, 1 least-used, 2 oldest
  double resolution_target;
  std::vector<Partition*> parts;

  ~Store() {
    for (auto* p : parts) delete p;
  }

  inline int part_of(int64_t key) const {
    return static_cast<int>((static_cast<uint64_t>(key) & 0x7fffffffULL) %
                            static_cast<uint64_t>(num_partitions));
  }

  void maybe_evict(Partition& p) const {
    uint64_t per_part = overflow_margin / num_partitions;
    if (per_part == 0) per_part = 1;
    if (p.count <= per_part) return;
    size_t target = static_cast<size_t>(per_part * resolution_target);
    std::mt19937_64 rng(p.tick);
    while (p.count > target && p.count > 0) {
      uint32_t victim = 0;
      size_t n = p.row_key.size();
      if (overflow_policy == 0) {
        victim = static_cast<uint32_t>(rng() % n);
      } else {
        const std::vector<uint64_t>& m =
            (overflow_policy == 1) ? p.last_used : p.inserted_at;
        uint64_t best = UINT64_MAX;
        for (size_t r = 0; r < n; ++r) {
          if (m[r] < best) { best = m[r]; victim = static_cast<uint32_t>(r); }
        }
      }
      p.erase_row(victim);
    }
  }
};

// A call on fewer keys than this runs its partitions on the calling thread:
// starting the threads costs more than the work (tens of microseconds each,
// up to 16 of them, against about 0.1 us a key). The embedding cache's miss
// merge, its write-backs and the update consumer make many such small calls.
constexpr int64_t kSerialBelowKeys = 16384;

// Bounded parallel-for over partitions; `keys` is the call's key count.
template <typename F>
void parallel_parts(int n, int64_t keys, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int workers = static_cast<int>(hw ? (hw < 16u ? hw : 16u) : 4u);
  if (workers > n) workers = n;
  if (workers <= 1 || keys < kSerialBelowKeys) {
    for (int p = 0; p < n; ++p) fn(p);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> ts;
  ts.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    ts.emplace_back([&] {
      int p;
      while ((p = next.fetch_add(1)) < n) fn(p);
    });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void* hps_kv_create(int dim, int num_partitions, uint64_t overflow_margin,
                    int overflow_policy, double resolution_target) {
  auto* s = new Store();
  s->dim = dim;
  s->num_partitions = num_partitions > 0 ? num_partitions : 1;
  s->overflow_margin = overflow_margin;
  s->overflow_policy = overflow_policy;
  s->resolution_target = resolution_target;
  s->parts.reserve(s->num_partitions);
  for (int i = 0; i < s->num_partitions; ++i) s->parts.push_back(new Partition(dim));
  return s;
}

void hps_kv_destroy(void* h) { delete static_cast<Store*>(h); }

// Upsert n pairs. keys [n], vectors [n*dim].
void hps_kv_insert(void* h, int64_t n, const int64_t* keys,
                   const float* vectors) {
  auto* s = static_cast<Store*>(h);
  // bucket indices by partition first (single pass)
  std::vector<std::vector<int64_t>> idx(s->num_partitions);
  for (int64_t i = 0; i < n; ++i) idx[s->part_of(keys[i])].push_back(i);
  parallel_parts(s->num_partitions, n, [&](int pi) {
    Partition& p = *s->parts[pi];
    if (idx[pi].empty()) return;
    std::unique_lock lock(p.mu);
    ++p.tick;
    for (int64_t i : idx[pi]) {
      int64_t key = keys[i];
      size_t slot = p.find(key);
      if (slot != SIZE_MAX) {
        uint32_t row = p.slot_row[slot];
        std::memcpy(&p.rows[size_t(row) * p.dim], vectors + i * s->dim,
                    sizeof(float) * p.dim);
        p.last_used[row] = p.tick;
      } else {
        uint32_t row = static_cast<uint32_t>(p.row_key.size());
        p.rows.insert(p.rows.end(), vectors + i * s->dim,
                      vectors + (i + 1) * s->dim);
        p.row_key.push_back(key);
        p.last_used.push_back(p.tick);
        p.inserted_at.push_back(p.tick);
        ++p.count;
        p.maybe_grow();
        p.place(key, row);
      }
    }
    s->maybe_evict(p);
  });
}

// Query n keys -> out [n*dim] (zero-filled for misses), found [n] (0/1).
void hps_kv_query(void* h, int64_t n, const int64_t* keys, float* out,
                  uint8_t* found) {
  auto* s = static_cast<Store*>(h);
  std::vector<std::vector<int64_t>> idx(s->num_partitions);
  for (int64_t i = 0; i < n; ++i) idx[s->part_of(keys[i])].push_back(i);
  parallel_parts(s->num_partitions, n, [&](int pi) {
    Partition& p = *s->parts[pi];
    if (idx[pi].empty()) return;
    std::shared_lock lock(p.mu);
    ++p.tick;  // benign race on tick under shared lock; ordering not load-bearing
    for (int64_t i : idx[pi]) {
      size_t slot = p.find(keys[i]);
      if (slot == SIZE_MAX) {
        std::memset(out + i * s->dim, 0, sizeof(float) * s->dim);
        found[i] = 0;
      } else {
        uint32_t row = p.slot_row[slot];
        std::memcpy(out + i * s->dim, &p.rows[size_t(row) * p.dim],
                    sizeof(float) * p.dim);
        p.last_used[row] = p.tick;
        found[i] = 1;
      }
    }
  });
}

int64_t hps_kv_evict(void* h, int64_t n, const int64_t* keys) {
  auto* s = static_cast<Store*>(h);
  std::vector<std::vector<int64_t>> idx(s->num_partitions);
  for (int64_t i = 0; i < n; ++i) idx[s->part_of(keys[i])].push_back(i);
  std::atomic<int64_t> evicted{0};
  parallel_parts(s->num_partitions, n, [&](int pi) {
    Partition& p = *s->parts[pi];
    if (idx[pi].empty()) return;
    std::unique_lock lock(p.mu);
    for (int64_t i : idx[pi]) {
      size_t slot = p.find(keys[i]);
      if (slot != SIZE_MAX) {
        p.erase_row(p.slot_row[slot]);
        evicted.fetch_add(1);
      }
    }
  });
  return evicted.load();
}

int64_t hps_kv_size(void* h) {
  auto* s = static_cast<Store*>(h);
  int64_t total = 0;
  for (auto* p : s->parts) {
    std::shared_lock lock(p->mu);
    total += static_cast<int64_t>(p->count);
  }
  return total;
}

// Caller allocates out_keys with hps_kv_size entries. Returns count written.
int64_t hps_kv_keys(void* h, int64_t* out_keys, int64_t cap) {
  auto* s = static_cast<Store*>(h);
  int64_t w = 0;
  for (auto* p : s->parts) {
    std::shared_lock lock(p->mu);
    for (int64_t k : p->row_key) {
      if (w >= cap) return w;
      out_keys[w++] = k;
    }
  }
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SlotMap: fixed-capacity key -> slot index with LRU eviction.
//
// Host-side index for the DYNAMIC HBM embedding cache (the reference's
// dynamic GPU cache maintains exactly this mapping device-side in CUDA,
// reference backend.cpp:483-491 cache types; here the host owns the index
// and the device stores rows at stable slot ids). `acquire` implements the
// insert path: present keys return their slot; new keys take a free slot or
// evict the least-recently-used one.
// ---------------------------------------------------------------------------

namespace {

struct SlotMap {
  int64_t capacity;
  std::vector<int64_t> slot_key;   // hash table: probe slot -> key
  std::vector<uint32_t> slot_val;  // probe slot -> cache slot id
  size_t mask = 0;
  std::vector<int64_t> cache_key;  // cache slot id -> key (kEmpty if free)
  std::vector<uint64_t> last_used; // cache slot id -> tick
  std::vector<uint32_t> free_list;
  // Min-heap of (tick, slot), one entry per occupied slot. An entry's tick
  // may be older than the slot's last_used (touches do not push): evict_lru
  // brings such an entry up to date when it surfaces, so the victim is the
  // one a scan would pick (the least last_used, the lowest slot on a tie) in
  // O(log capacity) amortized instead of a scan of every slot.
  std::vector<std::pair<uint64_t, uint32_t>> lru;
  uint64_t tick = 0;
  std::mutex mu;

  explicit SlotMap(int64_t cap) : capacity(cap) {
    size_t hcap = 1024;
    while (hcap * 3 < static_cast<size_t>(cap) * 5) hcap *= 2;  // load <= 0.6
    slot_key.assign(hcap, kEmpty);
    slot_val.assign(hcap, 0);
    mask = hcap - 1;
    cache_key.assign(cap, kEmpty);
    last_used.assign(cap, 0);
    free_list.reserve(cap);
    for (int64_t i = cap - 1; i >= 0; --i)
      free_list.push_back(static_cast<uint32_t>(i));
  }

  inline size_t find(int64_t key) const {
    size_t i = Partition::hash_key(key) & mask;
    while (true) {
      if (slot_key[i] == key) return i;
      if (slot_key[i] == kEmpty) return SIZE_MAX;
      i = (i + 1) & mask;
    }
  }

  inline void place(int64_t key, uint32_t val) {
    size_t i = Partition::hash_key(key) & mask;
    while (slot_key[i] != kEmpty) i = (i + 1) & mask;
    slot_key[i] = key;
    slot_val[i] = val;
  }

  void erase_probe(size_t i) {
    slot_key[i] = kEmpty;
    size_t j = i;
    while (true) {
      j = (j + 1) & mask;
      if (slot_key[j] == kEmpty) break;
      size_t ideal = Partition::hash_key(slot_key[j]) & mask;
      if ((i < j) ? (ideal <= i || ideal > j) : (ideal <= i && ideal > j)) {
        slot_key[i] = slot_key[j];
        slot_val[i] = slot_val[j];
        slot_key[j] = kEmpty;
        i = j;
      }
    }
  }

  // Occupied slots only: acquire evicts once the free list is empty.
  uint32_t evict_lru() {
    const auto later = std::greater<std::pair<uint64_t, uint32_t>>();
    while (true) {
      std::pop_heap(lru.begin(), lru.end(), later);
      auto& top = lru.back();
      if (last_used[top.second] == top.first) {
        const uint32_t victim = top.second;
        lru.pop_back();
        return victim;
      }
      top.first = last_used[top.second];
      std::push_heap(lru.begin(), lru.end(), later);
    }
  }

  // Slot s took a key at the current tick.
  void occupy(uint32_t s) {
    last_used[s] = tick;
    lru.emplace_back(tick, s);
    std::push_heap(lru.begin(), lru.end(),
                   std::greater<std::pair<uint64_t, uint32_t>>());
  }
};

}  // namespace

extern "C" {

void* hps_slotmap_create(int64_t capacity) { return new SlotMap(capacity); }
void hps_slotmap_destroy(void* h) { delete static_cast<SlotMap*>(h); }

// Translate n keys -> cache slots; missing keys get `miss_slot`. touch=1
// refreshes LRU ticks for hits.
void hps_slotmap_translate(void* h, int64_t n, const int64_t* keys,
                           int32_t* out_slots, int32_t miss_slot, int touch) {
  auto* m = static_cast<SlotMap*>(h);
  std::lock_guard<std::mutex> lock(m->mu);
  ++m->tick;
  for (int64_t i = 0; i < n; ++i) {
    size_t p = m->find(keys[i]);
    if (p == SIZE_MAX) {
      out_slots[i] = miss_slot;
    } else {
      uint32_t s = m->slot_val[p];
      out_slots[i] = static_cast<int32_t>(s);
      if (touch) m->last_used[s] = m->tick;
    }
  }
}

// Acquire slots for n keys (insert path). Existing keys keep their slot; new
// keys take a free slot or evict the LRU entry. out_slots[n]; out_evicted[n]
// receives the evicted key per insert (kEmpty/INT64_MIN if none). Returns the
// number of NEW insertions.
int64_t hps_slotmap_acquire(void* h, int64_t n, const int64_t* keys,
                            int32_t* out_slots, int64_t* out_evicted) {
  auto* m = static_cast<SlotMap*>(h);
  std::lock_guard<std::mutex> lock(m->mu);
  if (m->capacity <= 0) {
    // A zero-capacity map can satisfy nothing: report every key as a
    // non-insert at slot -1 (callers treat it as a miss). Without this
    // guard, evict_lru() on an empty map fabricated victim slot 0 and
    // wrote past the zero-length arrays (heap corruption).
    for (int64_t i = 0; i < n; ++i) {
      out_slots[i] = -1;
      out_evicted[i] = kEmpty;
    }
    return 0;
  }
  ++m->tick;
  int64_t inserted = 0;
  for (int64_t i = 0; i < n; ++i) {
    out_evicted[i] = kEmpty;
    size_t p = m->find(keys[i]);
    if (p != SIZE_MAX) {
      uint32_t s = m->slot_val[p];
      m->last_used[s] = m->tick;
      out_slots[i] = static_cast<int32_t>(s);
      continue;
    }
    uint32_t s;
    if (!m->free_list.empty()) {
      s = m->free_list.back();
      m->free_list.pop_back();
    } else {
      s = m->evict_lru();
      out_evicted[i] = m->cache_key[s];
      size_t vp = m->find(m->cache_key[s]);
      if (vp != SIZE_MAX) m->erase_probe(vp);
    }
    m->cache_key[s] = keys[i];
    m->occupy(s);
    m->place(keys[i], s);
    out_slots[i] = static_cast<int32_t>(s);
    ++inserted;
  }
  return inserted;
}

int64_t hps_slotmap_size(void* h) {
  auto* m = static_cast<SlotMap*>(h);
  std::lock_guard<std::mutex> lock(m->mu);
  return m->capacity - static_cast<int64_t>(m->free_list.size());
}

// Dump resident keys + their slots; returns count written.
int64_t hps_slotmap_keys(void* h, int64_t* out_keys, int32_t* out_slots,
                         int64_t cap) {
  auto* m = static_cast<SlotMap*>(h);
  std::lock_guard<std::mutex> lock(m->mu);
  int64_t w = 0;
  for (int64_t s = 0; s < m->capacity && w < cap; ++s) {
    if (m->cache_key[s] != kEmpty) {
      out_keys[w] = m->cache_key[s];
      out_slots[w] = static_cast<int32_t>(s);
      ++w;
    }
  }
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// StaticMap: immutable key -> slot index for STATIC embedding tables.
//
// The serving hot path translates every request key to its table slot on the
// host before the device gather (the reference does this probe inside its
// CUDA cache kernels, reference docs/architecture.md:29-32; on TPU the host
// owns translation so the device program stays static-shape). A sorted-array
// binary search costs ~360 ns/key on multi-million-row tables (~23 probes,
// each a cache miss); this open-addressing map is ~1.3 probes of one 16-byte
// cache line each, and bulk translation is read-only, so it runs lock-free
// and parallel on a persistent worker pool (the reference keeps an analogous
// native ThreadPool, reference thread_pool.cpp:28-35).
//
// slot i == position of keys[i] in the build array: bit-identical results to
// the numpy searchsorted index it replaces (tiers/hbm.py KeyIndex).
// ---------------------------------------------------------------------------

#include <pthread.h>

#include <condition_variable>
#include <functional>

namespace {

// Persistent pool: parallel_parts() spawns threads per call (fine for tier
// bulk ops) but a hot-path translate at ~100 us total cannot afford ~0.3 ms
// of thread spawns. Lazy singleton; run() blocks until all n tasks finish.
struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  // Serializes whole run() calls: cv_done.wait releases `mu`, so without
  // this a second concurrent run() could overwrite fn/total/next while the
  // first generation's workers are still fetching — they'd execute the OLD
  // fn with the NEW bounds. Callers (quantize, translate) each saturate the
  // cores anyway, so queueing concurrent runs costs nothing. NOTE: never
  // call run() from inside a pool task — it would self-deadlock here.
  std::mutex run_mu;
  std::condition_variable cv_work, cv_done;
  const std::function<void(int)>* fn = nullptr;
  int total = 0;
  std::atomic<int> next{0};
  std::atomic<int> done{0};
  uint64_t gen = 0;
  bool stop = false;

  // Heap singleton behind an atomic slot, NOT a function-local static:
  // fork() duplicates no worker threads, so a child inheriting a live Pool
  // would hang forever on its first run(). An atfork child handler nulls
  // the slot (leaking the stale object, whose threads do not exist in the
  // child) and the next get() builds a fresh pool. Never destructed —
  // also avoids joining workers during static-destruction at exit.
  static std::atomic<Pool*>& slot() {
    static std::atomic<Pool*> s{nullptr};
    return s;
  }

  static Pool& get() {
    Pool* p = slot().load(std::memory_order_acquire);
    if (p) return *p;
    static std::mutex create_mu;
    std::lock_guard<std::mutex> lk(create_mu);
    p = slot().load(std::memory_order_acquire);
    if (!p) {
      static bool registered = [] {
        pthread_atfork(nullptr, nullptr,
                       [] { slot().store(nullptr, std::memory_order_release); });
        return true;
      }();
      (void)registered;
      p = new Pool();
      slot().store(p, std::memory_order_release);
    }
    return *p;
  }

  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    int n = static_cast<int>(hw ? (hw < 16u ? hw : 16u) : 4u);
    for (int w = 0; w < n; ++w) workers.emplace_back([this] { loop(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  void loop() {
    uint64_t seen = 0;
    while (true) {
      const std::function<void(int)>* f;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [&] { return stop || gen != seen; });
        if (stop) return;
        seen = gen;
        f = fn;
      }
      int i;
      while ((i = next.fetch_add(1)) < total) (*f)(i);
      // The done increment must happen under `mu`: run() checks the wait
      // predicate while holding it, and an increment+notify issued between
      // that check and the sleep would otherwise be lost forever.
      {
        std::lock_guard<std::mutex> lk(mu);
        done.fetch_add(1);
      }
      cv_done.notify_all();
    }
  }

  void run(int n, const std::function<void(int)>& f) {
    if (n <= 1) {
      for (int i = 0; i < n; ++i) f(i);
      return;
    }
    std::lock_guard<std::mutex> run_lock(run_mu);
    std::unique_lock<std::mutex> lock(mu);
    fn = &f;
    total = n;
    next.store(0);
    done.store(0);
    ++gen;
    cv_work.notify_all();
    cv_done.wait(lock, [&] { return done.load() == static_cast<int>(workers.size()); });
  }
};

struct StaticEntry {
  int64_t key;
  int64_t val;
};

struct StaticMap {
  std::vector<StaticEntry> table;
  size_t mask = 0;
  int64_t empty_key_val = -1;  // slot for a real key == kEmpty sentinel

  StaticMap(int64_t n, const int64_t* keys) {
    size_t hcap = 64;
    while (hcap * 3 < static_cast<size_t>(n) * 4) hcap *= 2;  // load <= 0.75
    table.assign(hcap, StaticEntry{kEmpty, -1});
    mask = hcap - 1;
    for (int64_t i = 0; i < n; ++i) {
      if (keys[i] == kEmpty) {
        empty_key_val = i;
        continue;
      }
      size_t p = Partition::hash_key(keys[i]) & mask;
      while (table[p].key != kEmpty) p = (p + 1) & mask;
      table[p] = StaticEntry{keys[i], i};
    }
  }

  inline int64_t find(int64_t key) const {
    if (key == kEmpty) return empty_key_val;
    size_t p = Partition::hash_key(key) & mask;
    while (true) {
      const StaticEntry& e = table[p];
      if (e.key == key) return e.val;
      if (e.key == kEmpty) return -1;
      p = (p + 1) & mask;
    }
  }
};

constexpr int64_t kTranslateChunk = 8192;

inline void statmap_translate_range(const StaticMap* m, const int64_t* keys,
                                    int32_t* out, int64_t lo, int64_t hi,
                                    int32_t miss_slot) {
  for (int64_t i = lo; i < hi; ++i) {
    int64_t v = m->find(keys[i]);
    out[i] = v < 0 ? miss_slot : static_cast<int32_t>(v);
  }
}

}  // namespace

extern "C" {

void* hps_statmap_create(int64_t n, const int64_t* keys) {
  return new StaticMap(n, keys);
}

void hps_statmap_destroy(void* h) { delete static_cast<StaticMap*>(h); }

int64_t hps_statmap_nbytes(void* h) {
  auto* m = static_cast<StaticMap*>(h);
  return static_cast<int64_t>(m->table.size() * sizeof(StaticEntry));
}

// Translate n keys -> slots; missing keys get miss_slot. Read-only (no lock);
// chunks run on the persistent pool when n is large enough to amortize it.
void hps_statmap_translate(void* h, int64_t n, const int64_t* keys,
                           int32_t* out_slots, int32_t miss_slot) {
  auto* m = static_cast<StaticMap*>(h);
  if (n <= kTranslateChunk) {
    statmap_translate_range(m, keys, out_slots, 0, n, miss_slot);
    return;
  }
  int parts = static_cast<int>((n + kTranslateChunk - 1) / kTranslateChunk);
  Pool::get().run(parts, [&](int pi) {
    int64_t lo = static_cast<int64_t>(pi) * kTranslateChunk;
    int64_t hi = lo + kTranslateChunk < n ? lo + kTranslateChunk : n;
    statmap_translate_range(m, keys, out_slots, lo, hi, miss_slot);
  });
}

// Translate a whole multi-table request in ONE call: per-table key/out
// pointers (no concatenation copies on the caller side). All (table, chunk)
// units are scheduled on the pool together, so one big table cannot
// serialize the request. miss_slots[t] is per table.
void hps_statmap_translate_batch(int32_t n_tables, void** handles,
                                 const int64_t* counts,
                                 const int64_t* const* keys_ptrs,
                                 int32_t* const* out_ptrs,
                                 const int32_t* miss_slots) {
  struct Unit {
    const StaticMap* m;
    const int64_t* keys;
    int32_t* out;
    int64_t n;
    int32_t miss;
  };
  std::vector<Unit> units;
  int64_t total = 0;
  for (int32_t t = 0; t < n_tables; ++t) {
    auto* m = static_cast<StaticMap*>(handles[t]);
    total += counts[t];
    for (int64_t lo = 0; lo < counts[t]; lo += kTranslateChunk) {
      int64_t hi = lo + kTranslateChunk < counts[t] ? lo + kTranslateChunk
                                                    : counts[t];
      units.push_back(
          Unit{m, keys_ptrs[t] + lo, out_ptrs[t] + lo, hi - lo, miss_slots[t]});
    }
  }
  if (total <= kTranslateChunk || units.size() <= 1) {
    for (const Unit& u : units)
      statmap_translate_range(u.m, u.keys, u.out, 0, u.n, u.miss);
    return;
  }
  Pool::get().run(static_cast<int>(units.size()), [&](int i) {
    const Unit& u = units[i];
    statmap_translate_range(u.m, u.keys, u.out, 0, u.n, u.miss);
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch ops for the serving hot path: dynamic-cache translation and
// all-to-all dedup. Same motivation as StaticMap's batch translate — the
// host half of a lookup must pipeline under the device program, so
// per-table work runs in ONE call, parallel on the persistent pool.
// ---------------------------------------------------------------------------

extern "C" {

// Translate one multi-table request through DYNAMIC caches' SlotMaps: one
// pool unit per table (each SlotMap serializes on its own mutex, so
// intra-table chunking buys nothing; cross-table parallelism is the win).
// LRU-touch semantics identical to per-table hps_slotmap_translate calls.
void hps_slotmap_translate_batch(int32_t n_tables, void** handles,
                                 const int64_t* counts,
                                 const int64_t* const* keys_ptrs,
                                 int32_t* const* out_ptrs,
                                 const int32_t* miss_slots, int touch) {
  Pool::get().run(n_tables, [&](int t) {
    hps_slotmap_translate(handles[t], counts[t], keys_ptrs[t], out_ptrs[t],
                          miss_slots[t], touch);
  });
}

// Dedup int64 values preserving first-occurrence order:
//   out_uniq[0..r)  — unique values in first-seen order,
//   out_inv[i]      — index into out_uniq for values[i]  (len n),
// returns r. Open-addressing scratch sized for n (load <= 0.5); replaces
// np.unique's O(n log n) sort in the all-to-all routing plan
// (parallel/sharded_table.py plan_all_to_all). NOTE: first-seen order, not
// sorted — callers must not assume sortedness.
int64_t hps_dedup_i64(int64_t n, const int64_t* values, int64_t* out_uniq,
                      int32_t* out_inv) {
  size_t hcap = 64;
  while (hcap < static_cast<size_t>(n) * 2) hcap *= 2;
  std::vector<int64_t> hkey(hcap, kEmpty);
  std::vector<int32_t> hval(hcap, -1);
  size_t mask = hcap - 1;
  int64_t r = 0;
  int32_t empty_val = -1;  // a real kEmpty value in the input
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = values[i];
    if (v == kEmpty) {
      if (empty_val < 0) {
        empty_val = static_cast<int32_t>(r);
        out_uniq[r++] = v;
      }
      out_inv[i] = empty_val;
      continue;
    }
    size_t p = Partition::hash_key(v) & mask;
    while (true) {
      if (hkey[p] == v) {
        out_inv[i] = hval[p];
        break;
      }
      if (hkey[p] == kEmpty) {
        hkey[p] = v;
        hval[p] = static_cast<int32_t>(r);
        out_inv[i] = static_cast<int32_t>(r);
        out_uniq[r++] = v;
        break;
      }
      p = (p + 1) & mask;
    }
  }
  return r;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Row-wise quantization for the model-load path. numpy's op-chain
// (abs -> rowmax -> divide -> rint -> clip -> astype) materializes five
// full-table temporaries — measured 15 s for a 1M x 128 f32 table on the
// dev box; this single pass over the data runs chunk-parallel on the
// persistent pool. Bit-identical to the numpy path: f32 arithmetic,
// nearbyintf == np.rint (round-half-to-even under the default FP mode).
// ---------------------------------------------------------------------------

#include <cmath>

namespace {

inline void quantize_rows_range(const float* vecs, const int64_t* order,
                                int32_t dim, int64_t lo, int64_t hi,
                                float qmax, float qlo, float qhi, int mode,
                                int8_t* out8, uint8_t* out4, float* scales) {
  for (int64_t r = lo; r < hi; ++r) {
    const float* v = vecs + (order ? order[r] : r) * static_cast<int64_t>(dim);
    float absmax = 0.0f;
    for (int32_t j = 0; j < dim; ++j) {
      float a = std::fabs(v[j]);
      if (a > absmax) absmax = a;
    }
    // all-zero rows take absmax 1.0 BEFORE the qmax divide (numpy parity:
    // ops/quantize.py _row_scales); any finite scale dequantizes 0 -> 0.
    float scale = (absmax == 0.0f ? 1.0f : absmax) / qmax;
    scales[r] = scale;
    if (mode == 8) {
      int8_t* o = out8 + r * static_cast<int64_t>(dim);
      for (int32_t j = 0; j < dim; ++j) {
        float q = nearbyintf(v[j] / scale);
        if (q < qlo) q = qlo;
        if (q > qhi) q = qhi;
        o[j] = static_cast<int8_t>(q);
      }
    } else {  // mode == 4: nibble-packed, even col low nibble
      uint8_t* o = out4 + r * static_cast<int64_t>(dim / 2);
      for (int32_t j = 0; j < dim; j += 2) {
        float qa = nearbyintf(v[j] / scale);
        float qb = nearbyintf(v[j + 1] / scale);
        if (qa < qlo) qa = qlo;
        if (qa > qhi) qa = qhi;
        if (qb < qlo) qb = qlo;
        if (qb > qhi) qb = qhi;
        uint8_t ua = static_cast<uint8_t>(static_cast<int8_t>(qa)) & 0xF;
        uint8_t ub = static_cast<uint8_t>(static_cast<int8_t>(qb)) & 0xF;
        o[j / 2] = static_cast<uint8_t>(ua | (ub << 4));
      }
    }
  }
}

}  // namespace

extern "C" {

// mode 8: out is int8 [n, dim], clip [-127, 127], qmax 127.
// mode 4: out is packed uint8 [n, dim/2], clip [-7, 7], qmax 7 (dim even).
// order (nullable): source row for output row i is order[i] — folds the
// sorted-reorder gather into the quantization pass.
void hps_quantize_rows(int64_t n, int32_t dim, const float* vecs,
                       const int64_t* order, void* out, float* scales,
                       int32_t mode) {
  float qmax = mode == 8 ? 127.0f : 7.0f;
  float qlo = -qmax, qhi = qmax;
  int8_t* out8 = mode == 8 ? static_cast<int8_t*>(out) : nullptr;
  uint8_t* out4 = mode == 4 ? static_cast<uint8_t*>(out) : nullptr;
  const int64_t chunk = 16384;
  int64_t parts = (n + chunk - 1) / chunk;
  if (parts <= 1) {
    quantize_rows_range(vecs, order, dim, 0, n, qmax, qlo, qhi, mode, out8,
                        out4, scales);
    return;
  }
  // Bulk loads submit WAVES of bounded pool generations instead of one
  // giant run: run_mu serializes whole generations, so a hot-path translate
  // (~1 ms) must never queue behind a multi-hundred-ms full-table quantize.
  const int64_t wave = 32;  // ~0.5M rows per generation
  for (int64_t base_part = 0; base_part < parts; base_part += wave) {
    int wave_parts =
        static_cast<int>(parts - base_part < wave ? parts - base_part : wave);
    Pool::get().run(wave_parts, [&](int pi) {
      int64_t lo = (base_part + pi) * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      quantize_rows_range(vecs, order, dim, lo, hi, qmax, qlo, qhi, mode,
                          out8, out4, scales);
    });
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected poly 0x82F63B78) for the Kafka RecordBatch
// v2 checksum (update/record_batch.py; the v2 message format checksums
// attributes..records with CRC32C per KIP-98 — zlib's CRC32/IEEE does not
// match). Hardware SSE4.2 instruction when the build host has it
// (-march=native), slice-by-8 tables otherwise; both byte-identical.
// ---------------------------------------------------------------------------

#ifdef __SSE4_2__
#include <nmmintrin.h>
#endif

namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : (c >> 1);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

[[maybe_unused]] uint32_t crc32c_sw(uint32_t crc, const uint8_t* p,
                                    int64_t n) {
  static const Crc32cTables tbl;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;
    crc = tbl.t[7][w & 0xFF] ^ tbl.t[6][(w >> 8) & 0xFF] ^
          tbl.t[5][(w >> 16) & 0xFF] ^ tbl.t[4][(w >> 24) & 0xFF] ^
          tbl.t[3][(w >> 32) & 0xFF] ^ tbl.t[2][(w >> 40) & 0xFF] ^
          tbl.t[1][(w >> 48) & 0xFF] ^ tbl.t[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ tbl.t[0][(crc ^ *p++) & 0xFF];
  return crc;
}

}  // namespace

extern "C" {

// Incremental CRC32C: pass seed=0 to start, feed the PREVIOUS RETURN VALUE
// as seed to continue (pre/post inversion handled internally).
uint32_t hps_crc32c(const uint8_t* buf, int64_t n, uint32_t seed) {
  uint32_t crc = ~seed;
#ifdef __SSE4_2__
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, buf, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, w));
    buf += 8;
    n -= 8;
  }
  while (n-- > 0) crc = _mm_crc32_u8(crc, *buf++);
#else
  crc = crc32c_sw(crc, buf, n);
#endif
  return ~crc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Request merge / response regroup (serving/scheduler.py hot path).
//
// The continuous batcher merges N client requests into one device lookup
// (per-table key concatenation) and splits the flat table-major output back
// per request. In Python that is ~26 slice+concatenate ops per table or
// request — measured 2.4 ms of frontend software per merged 26-table batch
// (bench_artifacts/frontend_saturation.json), below the v5e device rate.
// Both directions are pure memcpy with fully precomputed geometry, so they
// run here with the GIL released (ctypes) in one call per batch.
// ---------------------------------------------------------------------------

extern "C" {

// Concatenate per-request per-table key runs into ONE table-major merged
// buffer (the per-table arrays are views at out_starts[t]).
//   keys_ptrs[r]  : request r's flat KEYS buffer (table-major within request)
//   numkeys       : [n_reqs * n_tables] row-major by request
//   out_starts[t] : element offset of table t's merged run in `out`
void hps_merge_requests(int32_t n_reqs, int32_t n_tables,
                        const int64_t** keys_ptrs, const int64_t* numkeys,
                        const int64_t* out_starts, int64_t* out) {
  std::vector<int64_t> out_off(n_tables, 0);
  for (int32_t r = 0; r < n_reqs; ++r) {
    const int64_t* src = keys_ptrs[r];
    const int64_t* nk = numkeys + static_cast<int64_t>(r) * n_tables;
    for (int32_t t = 0; t < n_tables; ++t) {
      const int64_t n = nk[t];
      std::memcpy(out + out_starts[t] + out_off[t], src,
                  n * sizeof(int64_t));
      out_off[t] += n;
      src += n;
    }
  }
}

// Regroup the flat TABLE-major (padded) lookup output into one contiguous
// REQUEST-major buffer; each request's response is then a zero-copy view.
//   flat    : device output, table runs padded to pad_counts rows
//   tstarts : [n_tables] element offset of each table's run in `flat`
//   dims    : [n_tables] row width per table
//   counts  : [n_reqs * n_tables] rows per (request, table), row-major
//   out     : caller-allocated, sum(counts[r][t] * dims[t]) floats
void hps_regroup_responses(int32_t n_reqs, int32_t n_tables,
                           const float* flat, const int64_t* tstarts,
                           const int64_t* dims, const int64_t* counts,
                           float* out) {
  std::vector<int64_t> in_off(n_tables, 0);  // consumed rows per table
  float* dst = out;
  for (int32_t r = 0; r < n_reqs; ++r) {
    const int64_t* cnt = counts + static_cast<int64_t>(r) * n_tables;
    for (int32_t t = 0; t < n_tables; ++t) {
      const int64_t n = cnt[t] * dims[t];
      std::memcpy(dst, flat + tstarts[t] + in_off[t] * dims[t],
                  n * sizeof(float));
      in_off[t] += cnt[t];
      dst += n;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Snappy / LZ4-block decompressors (update/compression.py fast path).
//
// Stock Kafka producers commonly compress update batches; when the optional
// python wheels are absent the consumer falls back to pure-Python decoders
// (correct, but per-byte loops). These native decoders keep multi-MB update
// batches off the Python bytecode path. Formats: raw snappy block
// (https format: varint preamble + literal/copy tags) and raw LZ4 block
// (token sequences); LZ4 frame parsing stays in Python, passing each block
// here with the shared output window so block-dependent frames work.
// ---------------------------------------------------------------------------

namespace {

// Back-reference copy with overlap semantics (bytes repeat the pattern).
// Non-overlapping: one memcpy. Overlapping: seed with the pattern, then
// double from the freshly written region.
inline void lz_match_copy(uint8_t* dst, int64_t out, int64_t offset,
                          int64_t len) {
  if (offset >= len) {
    std::memcpy(dst + out, dst + out - offset, len);
    return;
  }
  std::memcpy(dst + out, dst + out - offset, offset);
  int64_t have = offset;
  while (have < len) {
    const int64_t chunk = (have < len - have) ? have : len - have;
    std::memcpy(dst + out + have, dst + out, chunk);
    have += chunk;
  }
}

}  // namespace

extern "C" {

// Raw snappy block: src[0..n) -> dst (cap bytes). Returns bytes written,
// -1 on malformed input or insufficient cap.
int64_t hps_snappy_raw(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
  int64_t pos = 0;
  uint64_t total = 0;
  int shift = 0;
  while (pos < n) {  // preamble varint: uncompressed length
    uint8_t b = src[pos++];
    total |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 35) return -1;
  }
  if (static_cast<int64_t>(total) > cap) return -1;
  int64_t out = 0;
  while (pos < n) {
    const uint8_t tag = src[pos++];
    const int kind = tag & 3;
    if (kind == 0) {  // literal
      int64_t len = tag >> 2;
      if (len >= 60) {
        const int extra = static_cast<int>(len) - 59;
        if (pos + extra > n) return -1;
        len = 0;
        for (int i = 0; i < extra; ++i)
          len |= static_cast<int64_t>(src[pos + i]) << (8 * i);
        pos += extra;
      }
      len += 1;
      if (pos + len > n || out + len > cap) return -1;
      std::memcpy(dst + out, src + pos, len);
      pos += len;
      out += len;
      continue;
    }
    int64_t len, offset;
    if (kind == 1) {
      if (pos >= n) return -1;
      len = ((tag >> 2) & 0x7) + 4;
      offset = (static_cast<int64_t>(tag >> 5) << 8) | src[pos++];
    } else if (kind == 2) {
      if (pos + 2 > n) return -1;
      len = (tag >> 2) + 1;
      offset = src[pos] | (static_cast<int64_t>(src[pos + 1]) << 8);
      pos += 2;
    } else {
      if (pos + 4 > n) return -1;
      len = (tag >> 2) + 1;
      offset = 0;
      for (int i = 0; i < 4; ++i)
        offset |= static_cast<int64_t>(src[pos + i]) << (8 * i);
      pos += 4;
    }
    if (offset <= 0 || offset > out || out + len > cap) return -1;
    lz_match_copy(dst, out, offset, len);
    out += len;
  }
  if (out != static_cast<int64_t>(total)) return -1;
  return out;
}

// Raw LZ4 block appended to a shared window: dst already holds `pos` bytes
// (prior blocks — matches may reach into them). Returns the new window end,
// -1 on malformed input or insufficient cap.
int64_t hps_lz4_block(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap, int64_t pos) {
  int64_t ip = 0;
  int64_t out = pos;
  while (ip < n) {
    const uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || out + lit > cap) return -1;
    std::memcpy(dst + out, src + ip, lit);
    ip += lit;
    out += lit;
    if (ip >= n) break;  // final sequence: literals only
    if (ip + 2 > n) return -1;
    const int64_t offset =
        src[ip] | (static_cast<int64_t>(src[ip + 1]) << 8);
    ip += 2;
    if (offset <= 0 || offset > out) return -1;
    int64_t ml = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    if (out + ml > cap) return -1;
    lz_match_copy(dst, out, offset, ml);
    out += ml;
  }
  return out;
}

}  // extern "C"
