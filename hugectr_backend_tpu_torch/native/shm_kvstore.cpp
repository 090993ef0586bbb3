// Multi-process shared-memory KV store: /dev/shm embedding table shared by
// every serving process on a host.
//
// A copy of the JAX package's native/shm_kvstore.cpp, built with kvstore.cpp
// into one library. Counterpart of the reference's `multi_process_hash_map`
// volatile database (reference docs/hierarchical_parameter_server.md:404,
// 417-421: a hash map "backed by shared memory" in /dev/shm with
// `shared_memory_size` / `shared_memory_name` / `shared_memory_auto_remove`),
// exposed over a C ABI (ctypes).
//
// Design (everything offset-based — the segment maps at different addresses
// in different processes):
//   - one POSIX shm segment per (database, table), capacity fixed from the
//     shared-memory budget at creation;
//   - the empty state is ALL-ZERO so freshly ftruncate'd pages need no
//     initialization (a 16 GB default segment would otherwise cost minutes
//     and 16 GB of RSS up front): hash-slot occupancy lives in slot_row
//     (0 = empty, row index stored +1), rows allocate from a per-partition
//     watermark, and scans stop at the watermark;
//   - per-partition open-addressing int64->row table (linear probe, backshift
//     deletion) + row arena + free-list of explicitly freed rows;
//   - pthread process-shared rwlocks, one per partition: concurrent readers
//     across processes, exclusive writers;
//   - partition = key low bits (reference docs/architecture.md:131);
//   - overflow: when a partition is full, evict down to
//     `resolution_target * capacity` by policy 0=random, 1=least-used,
//     2=oldest (reference docs/hierarchical_parameter_server.md:460-487);
//   - creator initializes the header then publishes a magic word with
//     release ordering; attachers validate geometry.
//
// Limitation: key INT64_MIN is reserved as the freed-row marker.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x48505354505553ULL;  // "HPSTPUS"
constexpr int64_t kFreed = INT64_MIN;
constexpr uint32_t kMaxParts = 64;
constexpr uint32_t kNoRow = UINT32_MAX;

struct Header {
  std::atomic<uint64_t> magic;  // kMagic once fully initialized
  uint32_t version;
  uint32_t dim;
  uint32_t num_partitions;
  uint32_t policy;
  uint64_t cap_per_part;    // row capacity per partition
  uint64_t slots_per_part;  // hash slots per partition (power of two)
  double resolution_target;
  pthread_rwlock_t locks[kMaxParts];
  uint64_t counts[kMaxParts];
  uint64_t free_tops[kMaxParts];
  uint64_t watermarks[kMaxParts];  // rows ever allocated (sequential)
  uint64_t ticks[kMaxParts];
};

// Per-partition arrays, laid out after the header:
//   int64  slot_key [slots]   (valid only where slot_row != 0)
//   uint32 slot_row [slots]   (0 = empty, else row index + 1)
//   int64  row_key  [cap]     (valid for rows < watermark; kFreed = freed)
//   uint64 last_used[cap]
//   uint64 inserted [cap]
//   uint32 free_rows[cap]
//   float  rows     [cap * dim]
struct PartView {
  int64_t* slot_key;
  uint32_t* slot_row;
  int64_t* row_key;
  uint64_t* last_used;
  uint64_t* inserted;
  uint32_t* free_rows;
  float* rows;
};

size_t part_bytes(uint64_t slots, uint64_t cap, uint32_t dim) {
  size_t b = 0;
  b += slots * sizeof(int64_t) + slots * sizeof(uint32_t);
  b += cap * (sizeof(int64_t) + 2 * sizeof(uint64_t) + sizeof(uint32_t));
  b += cap * dim * sizeof(float);
  return (b + 63) & ~size_t(63);  // 64B align partitions
}

struct Store {
  Header* hdr = nullptr;
  void* base = nullptr;
  size_t map_len = 0;
  char shm_name[256];

  PartView part(uint32_t p) const {
    const uint64_t slots = hdr->slots_per_part, cap = hdr->cap_per_part;
    const uint32_t dim = hdr->dim;
    char* q = static_cast<char*>(base) + ((sizeof(Header) + 63) & ~size_t(63)) +
              size_t(p) * part_bytes(slots, cap, dim);
    PartView v;
    v.slot_key = reinterpret_cast<int64_t*>(q);
    q += slots * sizeof(int64_t);
    v.slot_row = reinterpret_cast<uint32_t*>(q);
    q += slots * sizeof(uint32_t);
    v.row_key = reinterpret_cast<int64_t*>(q);
    q += cap * sizeof(int64_t);
    v.last_used = reinterpret_cast<uint64_t*>(q);
    q += cap * sizeof(uint64_t);
    v.inserted = reinterpret_cast<uint64_t*>(q);
    q += cap * sizeof(uint64_t);
    v.free_rows = reinterpret_cast<uint32_t*>(q);
    q += cap * sizeof(uint32_t);
    v.rows = reinterpret_cast<float*>(q);
    return v;
  }
};

inline uint64_t hash_key(int64_t k) {
  uint64_t x = static_cast<uint64_t>(k);
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

inline uint32_t part_of(int64_t key, uint32_t parts) {
  return static_cast<uint32_t>(static_cast<uint64_t>(key) & (parts - 1));
}

uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Find the hash slot holding `key`, or the empty slot where it would go.
inline uint64_t probe(const PartView& v, uint64_t mask, int64_t key) {
  uint64_t s = hash_key(key) & mask;
  while (v.slot_row[s] != 0 && v.slot_key[s] != key) s = (s + 1) & mask;
  return s;
}

inline bool occupied_match(const PartView& v, uint64_t s, int64_t key) {
  return v.slot_row[s] != 0 && v.slot_key[s] == key;
}

// Backshift deletion keeps probe chains tombstone-free.
void erase_slot(const PartView& v, uint64_t mask, uint64_t s) {
  v.slot_row[s] = 0;
  uint64_t hole = s, cur = (s + 1) & mask;
  while (v.slot_row[cur] != 0) {
    uint64_t home = hash_key(v.slot_key[cur]) & mask;
    bool movable = (hole <= cur) ? (home <= hole || home > cur)
                                 : (home <= hole && home > cur);
    if (movable) {
      v.slot_key[hole] = v.slot_key[cur];
      v.slot_row[hole] = v.slot_row[cur];
      v.slot_row[cur] = 0;
      hole = cur;
    }
    cur = (cur + 1) & mask;
  }
}

inline bool row_in_use(const PartView& v, uint64_t r) {
  return v.row_key[r] != kFreed;
}

void evict_partition(Store* st, uint32_t p, const PartView& v) {
  Header* h = st->hdr;
  const uint64_t mask = h->slots_per_part - 1;
  const uint64_t wm = h->watermarks[p];
  uint64_t target =
      static_cast<uint64_t>(h->resolution_target * double(h->cap_per_part));
  if (target >= h->counts[p]) target = h->counts[p] ? h->counts[p] - 1 : 0;
  std::mt19937_64 rng(h->ticks[p] + p);
  auto evict_row = [&](uint32_t victim) {
    uint64_t s = probe(v, mask, v.row_key[victim]);
    if (occupied_match(v, s, v.row_key[victim])) erase_slot(v, mask, s);
    v.row_key[victim] = kFreed;
    v.free_rows[h->free_tops[p]++] = victim;
    h->counts[p]--;
  };
  if (h->policy == 0 && wm) {  // evict_random: sampled probes
    int stuck = 0;
    while (h->counts[p] > target) {
      uint32_t r = static_cast<uint32_t>(rng() % wm);
      if (row_in_use(v, r)) {
        evict_row(r);
        stuck = 0;
      } else if (++stuck > 256) {
        break;  // pathological occupancy: fall through to the batch path
      }
    }
    if (h->counts[p] <= target) return;
  }
  // least-used / oldest (and the random fallback): ONE pass collecting
  // (score, row), then a partial sort selecting the whole eviction batch.
  // The previous per-victim full scan made one overflow insert
  // O(cap * n_evict) inside the partition WRITE lock, stalling every
  // co-hosted serving process's queries for the duration.
  if (h->counts[p] <= target) return;
  const uint64_t n_evict = h->counts[p] - target;
  const uint64_t* score = (h->policy == 2) ? v.inserted : v.last_used;
  std::vector<std::pair<uint64_t, uint32_t>> cand;
  cand.reserve(h->counts[p]);
  for (uint64_t r = 0; r < wm; ++r) {
    if (row_in_use(v, r))
      cand.emplace_back(score[r], static_cast<uint32_t>(r));
  }
  const size_t k = std::min<size_t>(n_evict, cand.size());
  std::nth_element(cand.begin(), cand.begin() + k, cand.end());
  for (size_t i = 0; i < k; ++i) evict_row(cand[i].second);
}

}  // namespace

extern "C" {

// create != 0: create the segment if absent (or attach if present);
// create == 0: attach only. Returns NULL on error or geometry mismatch.
void* hps_shmkv_open(const char* name, int dim, int num_partitions,
                     uint64_t capacity_rows, int policy,
                     double resolution_target, int create) {
  if (dim <= 0 || num_partitions <= 0) return nullptr;
  uint32_t parts = 1;  // power of two <= kMaxParts
  while (parts * 2 <= static_cast<uint32_t>(num_partitions) &&
         parts * 2 <= kMaxParts)
    parts <<= 1;
  uint64_t cap = (capacity_rows + parts - 1) / parts;
  if (cap < 16) cap = 16;
  uint64_t slots = next_pow2(cap * 2);  // load factor <= 0.5
  size_t len = ((sizeof(Header) + 63) & ~size_t(63)) +
               size_t(parts) * part_bytes(slots, cap, dim);

  bool creator = false;
  int fd = -1;
  if (create) {
    fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd >= 0) {
      creator = true;
      if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
        close(fd);
        shm_unlink(name);
        return nullptr;
      }
    } else if (errno != EEXIST) {
      return nullptr;
    }
  }
  if (fd < 0) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    // Attach: wait for the creator to finish ftruncate.
    struct stat sb = {};
    for (int i = 0; i < 10000; ++i) {
      if (fstat(fd, &sb) == 0 && static_cast<size_t>(sb.st_size) >= len) break;
      usleep(100);
    }
    if (static_cast<size_t>(sb.st_size) < len) {
      close(fd);
      return nullptr;
    }
  }
  void* base = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  Store* st = new Store;
  st->base = base;
  st->map_len = len;
  st->hdr = static_cast<Header*>(base);
  snprintf(st->shm_name, sizeof(st->shm_name), "%s", name);
  Header* h = st->hdr;

  if (creator) {
    // Everything data-plane is zero-initialized by ftruncate; only the
    // header needs real initialization — creation is O(1) in capacity.
    h->version = 1;
    h->dim = static_cast<uint32_t>(dim);
    h->num_partitions = parts;
    h->policy = static_cast<uint32_t>(policy);
    h->cap_per_part = cap;
    h->slots_per_part = slots;
    h->resolution_target = resolution_target;
    pthread_rwlockattr_t attr;
    pthread_rwlockattr_init(&attr);
    pthread_rwlockattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    for (uint32_t p = 0; p < parts; ++p) pthread_rwlock_init(&h->locks[p], &attr);
    pthread_rwlockattr_destroy(&attr);
    h->magic.store(kMagic, std::memory_order_release);
  } else {
    // Wait for the creator's publish, then validate geometry.
    for (int i = 0; i < 100000; ++i) {
      if (h->magic.load(std::memory_order_acquire) == kMagic) break;
      usleep(100);
    }
    if (h->magic.load(std::memory_order_acquire) != kMagic ||
        h->dim != static_cast<uint32_t>(dim) || h->num_partitions != parts ||
        h->cap_per_part != cap || h->slots_per_part != slots) {
      munmap(base, len);
      delete st;
      return nullptr;
    }
  }
  return st;
}

void hps_shmkv_close(void* handle) {
  Store* st = static_cast<Store*>(handle);
  if (!st) return;
  munmap(st->base, st->map_len);
  delete st;
}

int hps_shmkv_unlink(const char* name) { return shm_unlink(name); }

void hps_shmkv_insert(void* handle, int64_t n, const int64_t* keys,
                      const float* vecs) {
  Store* st = static_cast<Store*>(handle);
  Header* h = st->hdr;
  const uint32_t parts = h->num_partitions;
  const uint64_t mask = h->slots_per_part - 1;
  const uint32_t dim = h->dim;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] == kFreed) continue;  // reserved sentinel
    const uint32_t p = part_of(keys[i], parts);
    PartView v = st->part(p);
    pthread_rwlock_wrlock(&h->locks[p]);
    h->ticks[p]++;
    uint64_t s = probe(v, mask, keys[i]);
    uint32_t r;
    if (occupied_match(v, s, keys[i])) {
      r = v.slot_row[s] - 1;
    } else {
      if (h->free_tops[p] == 0 && h->watermarks[p] >= h->cap_per_part) {
        evict_partition(st, p, v);
        s = probe(v, mask, keys[i]);  // eviction moved slots around
        if (h->free_tops[p] == 0 && h->watermarks[p] >= h->cap_per_part) {
          pthread_rwlock_unlock(&h->locks[p]);
          continue;  // zero-capacity partition: drop
        }
      }
      r = (h->free_tops[p] > 0)
              ? v.free_rows[--h->free_tops[p]]
              : static_cast<uint32_t>(h->watermarks[p]++);
      v.slot_key[s] = keys[i];
      v.slot_row[s] = r + 1;
      v.row_key[r] = keys[i];
      v.inserted[r] = h->ticks[p];
      h->counts[p]++;
    }
    std::memcpy(v.rows + size_t(r) * dim, vecs + size_t(i) * dim,
                size_t(dim) * sizeof(float));
    v.last_used[r] = h->ticks[p];
    pthread_rwlock_unlock(&h->locks[p]);
  }
}

void hps_shmkv_query(void* handle, int64_t n, const int64_t* keys, float* out,
                     uint8_t* found) {
  Store* st = static_cast<Store*>(handle);
  Header* h = st->hdr;
  const uint32_t parts = h->num_partitions;
  const uint64_t mask = h->slots_per_part - 1;
  const uint32_t dim = h->dim;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t p = part_of(keys[i], parts);
    PartView v = st->part(p);
    pthread_rwlock_rdlock(&h->locks[p]);
    uint64_t s = probe(v, mask, keys[i]);
    if (occupied_match(v, s, keys[i])) {
      const uint32_t r = v.slot_row[s] - 1;
      std::memcpy(out + size_t(i) * dim, v.rows + size_t(r) * dim,
                  size_t(dim) * sizeof(float));
      v.last_used[r] = h->ticks[p];  // benign read-lock race: only a hint
      found[i] = 1;
    } else {
      std::memset(out + size_t(i) * dim, 0, size_t(dim) * sizeof(float));
      found[i] = 0;
    }
    pthread_rwlock_unlock(&h->locks[p]);
  }
}

int64_t hps_shmkv_evict(void* handle, int64_t n, const int64_t* keys) {
  Store* st = static_cast<Store*>(handle);
  Header* h = st->hdr;
  const uint32_t parts = h->num_partitions;
  const uint64_t mask = h->slots_per_part - 1;
  int64_t removed = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t p = part_of(keys[i], parts);
    PartView v = st->part(p);
    pthread_rwlock_wrlock(&h->locks[p]);
    uint64_t s = probe(v, mask, keys[i]);
    if (occupied_match(v, s, keys[i])) {
      const uint32_t r = v.slot_row[s] - 1;
      erase_slot(v, mask, s);
      v.row_key[r] = kFreed;
      v.free_rows[h->free_tops[p]++] = r;
      h->counts[p]--;
      removed++;
    }
    pthread_rwlock_unlock(&h->locks[p]);
  }
  return removed;
}

int64_t hps_shmkv_size(void* handle) {
  Store* st = static_cast<Store*>(handle);
  Header* h = st->hdr;
  int64_t total = 0;
  for (uint32_t p = 0; p < h->num_partitions; ++p) {
    pthread_rwlock_rdlock(&h->locks[p]);
    total += static_cast<int64_t>(h->counts[p]);
    pthread_rwlock_unlock(&h->locks[p]);
  }
  return total;
}

int64_t hps_shmkv_keys(void* handle, int64_t* out_keys, int64_t cap_out) {
  Store* st = static_cast<Store*>(handle);
  Header* h = st->hdr;
  int64_t written = 0;
  for (uint32_t p = 0; p < h->num_partitions; ++p) {
    PartView v = st->part(p);
    pthread_rwlock_rdlock(&h->locks[p]);
    for (uint64_t r = 0; r < h->watermarks[p] && written < cap_out; ++r) {
      if (row_in_use(v, r)) out_keys[written++] = v.row_key[r];
    }
    pthread_rwlock_unlock(&h->locks[p]);
  }
  return written;
}

int64_t hps_shmkv_capacity(void* handle) {
  Store* st = static_cast<Store*>(handle);
  return static_cast<int64_t>(st->hdr->cap_per_part) *
         st->hdr->num_partitions;
}

}  // extern "C"
