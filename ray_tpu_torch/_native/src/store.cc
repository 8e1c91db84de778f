// Shared-memory object store: the TPU-native plasma equivalent.
//
// Re-designed from the behavior of the reference's per-node object store
// (ref: src/ray/object_manager/plasma/store.h:55, object_store.h:76,
// eviction_policy.h, dlmalloc.cc) — create/seal/get/release/delete with
// blocking gets, LRU eviction of unreferenced sealed objects, and a
// boundary-tag first-fit allocator inside one mmap'd POSIX shm arena.
// Unlike plasma there is no client socket protocol: every process on the
// node maps the arena directly and synchronizes through process-shared
// robust mutexes — one less hop, which matters because on a TPU host the
// store's job is feeding host->device transfers at HBM-ingest rate.
//
// Also hosts mutable channel objects: the equivalent of the reference's
// experimental mutable-object protocol for compiled graphs
// (ref: src/ray/core_worker/experimental_mutable_object_manager.h:44,
// WriteAcquire/ReadAcquire at :156/:181) — a versioned single-writer,
// N-reader ring cell with process-shared condvars.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#if defined(__x86_64__) || defined(_M_X64)
#include <emmintrin.h>  // SSE2 streaming stores (rt_copy_nt)
#endif
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545354'4f524532ull;  // "RTSTORE2"
constexpr int kIdSize = 20;
constexpr uint64_t kAlign = 64;

enum EntryState : uint32_t {
  kFree = 0,
  kCreated = 1,
  kSealed = 2,
  kChannel = 3,
  kEvicted = 4,  // tombstone: data freed by LRU; id remembered so a later
                 // get() fails fast (ObjectLostError / lineage reconstruction)
                 // instead of blocking forever
};

enum Error : int {
  kOK = 0,
  kNotFound = -1,
  kExists = -2,
  kOutOfMemory = -3,
  kTimeout = -4,
  kBadState = -5,
  kSysError = -6,
  kClosed = -7,
  kLost = -8,  // object was evicted after having been sealed
};

// Chaos fault arm (devtools/chaos): every Nth rt_seal reports kSysError
// while leaving the entry kCreated, so a retry can succeed — the forced
// version of a shm-layer seal failure. Armed via RT_CHAOS_STORE_SEAL_
// FAIL_EVERY at dlopen or rt_store_chaos_set at runtime; disarmed cost
// is one relaxed load of a zero. Atomics: no new TSAN race.
uint64_t env_every(const char* name) {
  const char* raw = getenv(name);
  if (!raw) return 0;
  char* end = nullptr;
  unsigned long long v = strtoull(raw, &end, 10);
  return (end && *end == '\0') ? (uint64_t)v : 0;
}

uint64_t g_chaos_seal_every = env_every("RT_CHAOS_STORE_SEAL_FAIL_EVERY");
uint64_t g_chaos_seal_ctr = 0;

bool chaos_seal_strike() {
  uint64_t every = __atomic_load_n(&g_chaos_seal_every, __ATOMIC_RELAXED);
  if (every == 0) return false;
  return __atomic_add_fetch(&g_chaos_seal_ctr, 1, __ATOMIC_RELAXED) % every == 0;
}

constexpr int kReaders = 4;  // reader processes an entry keeps by pid

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;  // data offset from arena base
  uint64_t size;    // user-visible size
  int32_t refcnt;
  uint32_t pad;
  uint64_t lru_seq;
  // the first kReaders processes holding rt_get references, and how many
  // each holds (0: a free slot): a reader that dies holding a zero-copy
  // view never releases it, and rt_delete takes its references back
  int32_t reader_pid[kReaders];
  int32_t reader_refs[kReaders];
};

struct Block {  // boundary-tag allocator block header, padded so the user
                // data that follows it stays 64-byte aligned (DMA/vector
                // loads; serialization.py promises this alignment)
  uint64_t size;  // total block size incl. header+footer
  uint64_t free;  // 1 = free
  uint8_t pad[kAlign - 2 * sizeof(uint64_t)];
};
static_assert(sizeof(Block) == kAlign, "data after Block must stay aligned");
// footer: uint64_t size at block end - 8

struct ChannelHeader {  // lives at the start of a channel's data block
  pthread_mutex_t mu;
  pthread_cond_t cv;
  uint64_t version;        // incremented by each WriteRelease
  uint64_t payload_size;   // bytes written for the current version
  uint32_t num_readers;    // readers per version
  int32_t readers_left;    // acks outstanding for current version
  uint32_t closed;
  uint32_t pad;
};

// Arena-wide counters in the shared header, updated under the store
// mutex (plain adds) and read out via rt_store_stats for the metrics
// flush — the metric_defs.cc objects-family role for the local arena.
struct StoreStats {
  uint64_t creates;        // successful object creations
  uint64_t create_bytes;
  uint64_t seals;
  uint64_t gets;           // successful (sealed) reads
  uint64_t get_waits;      // futex sleeps inside blocking gets
  uint64_t get_lost;       // gets that hit an eviction tombstone
  uint64_t releases;
  uint64_t deletes;
  uint64_t evictions;      // LRU victims freed under pressure
  uint64_t evicted_bytes;
  uint64_t peak_bytes;     // max observed bytes_in_use
};
constexpr int kStoreStatsFields = sizeof(StoreStats) / sizeof(uint64_t);

struct StoreHeader {
  uint64_t magic;
  uint64_t capacity;     // total file size
  uint64_t table_off;
  uint64_t table_slots;
  uint64_t data_off;
  uint64_t data_size;
  pthread_mutex_t mu;
  pthread_cond_t cv;     // broadcast on seal/delete/release
  uint64_t lru_clock;
  uint64_t bytes_in_use;
  uint32_t closed;
  uint32_t pad;
  StoreStats stats;
};

struct Handle {
  StoreHeader* hdr;
  uint8_t* base;
  uint64_t capacity;
  int fd;
};

uint64_t align_up(uint64_t n, uint64_t a) { return (n + a - 1) & ~(a - 1); }

// ---- locking helpers (robust mutex: survive client crashes) ----

int lock(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

// pthread_cond_(timed)wait reacquires the mutex and can itself observe the
// previous owner's death: repair the mutex or every later lock() fails with
// ENOTRECOVERABLE and the store is bricked after one client crash.
int cond_wait(pthread_cond_t* cv, pthread_mutex_t* mu) {
  int rc = pthread_cond_wait(cv, mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

int cond_timedwait(pthread_cond_t* cv, pthread_mutex_t* mu, const timespec* ts) {
  int rc = pthread_cond_timedwait(cv, mu, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

void init_mutex(pthread_mutex_t* mu) {
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(mu, &ma);
  pthread_mutexattr_destroy(&ma);
}

void init_cond(pthread_cond_t* cv) {
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(cv, &ca);
  pthread_condattr_destroy(&ca);
}

void deadline_after_ms(int64_t ms, timespec* ts) {
  clock_gettime(CLOCK_MONOTONIC, ts);
  ts->tv_sec += ms / 1000;
  ts->tv_nsec += (ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

// ---- allocator: boundary tags, first fit, coalescing ----

constexpr uint64_t kBlockOverhead = sizeof(Block) + sizeof(uint64_t);

uint64_t* footer_of(uint8_t* data_base, Block* b) {
  return reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(b) + b->size -
                                     sizeof(uint64_t));
}

void write_block(uint8_t* data_base, Block* b, uint64_t size, uint64_t free) {
  b->size = size;
  b->free = free;
  *footer_of(data_base, b) = size;
}

Block* next_block(uint8_t* data_base, uint64_t data_size, Block* b) {
  uint8_t* n = reinterpret_cast<uint8_t*>(b) + b->size;
  if (n >= data_base + data_size) return nullptr;
  return reinterpret_cast<Block*>(n);
}

Block* prev_block(uint8_t* data_base, Block* b) {
  uint8_t* p = reinterpret_cast<uint8_t*>(b);
  if (p == data_base) return nullptr;
  uint64_t prev_size = *reinterpret_cast<uint64_t*>(p - sizeof(uint64_t));
  return reinterpret_cast<Block*>(p - prev_size);
}

// Allocate `user_size` bytes; returns data offset from arena base or 0.
uint64_t alloc_locked(Handle* h, uint64_t user_size) {
  StoreHeader* s = h->hdr;
  uint8_t* data_base = h->base + s->data_off;
  uint64_t need = align_up(user_size + kBlockOverhead, kAlign);
  Block* b = reinterpret_cast<Block*>(data_base);
  while (b) {
    if (b->free && b->size >= need) {
      uint64_t remainder = b->size - need;
      if (remainder >= kBlockOverhead + kAlign) {
        write_block(data_base, b, need, 0);
        Block* rest = next_block(data_base, s->data_size, b);
        write_block(data_base, rest, remainder, 1);
      } else {
        b->free = 0;
        *footer_of(data_base, b) = b->size;
      }
      s->bytes_in_use += b->size;
      return (reinterpret_cast<uint8_t*>(b) - h->base) + sizeof(Block);
    }
    b = next_block(data_base, s->data_size, b);
  }
  return 0;
}

void free_locked(Handle* h, uint64_t data_offset) {
  StoreHeader* s = h->hdr;
  uint8_t* data_base = h->base + s->data_off;
  Block* b = reinterpret_cast<Block*>(h->base + data_offset - sizeof(Block));
  s->bytes_in_use -= b->size;
  b->free = 1;
  // coalesce with next
  Block* n = next_block(data_base, s->data_size, b);
  if (n && n->free) write_block(data_base, b, b->size + n->size, 1);
  // coalesce with prev
  Block* p = prev_block(data_base, b);
  if (p && p->free) write_block(data_base, p, p->size + b->size, 1);
  else *footer_of(data_base, b) = b->size;
}

// ---- object table: open addressing on id hash ----

uint64_t hash_id(const uint8_t* id) {
  uint64_t x;
  memcpy(&x, id, 8);
  uint64_t y;
  memcpy(&y, id + 8, 8);
  uint32_t z;  // ObjectIDs are task_id(16) + return_index(4): the tail must
  memcpy(&z, id + 16, 4);  // feed the hash or one task's returns all collide
  x ^= y * 0x9e3779b97f4a7c15ull;
  x ^= (uint64_t)z * 0xc2b2ae3d27d4eb4full;
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  return x;
}

Entry* table(Handle* h) {
  return reinterpret_cast<Entry*>(h->base + h->hdr->table_off);
}

Entry* find_entry(Handle* h, const uint8_t* id) {
  Entry* t = table(h);
  uint64_t slots = h->hdr->table_slots;
  uint64_t i = hash_id(id) % slots;
  for (uint64_t probe = 0; probe < slots; ++probe) {
    Entry* e = &t[i];
    if (e->state == kFree) return nullptr;
    if (memcmp(e->id, id, kIdSize) == 0 && e->state != kFree) return e;
    i = (i + 1) % slots;
  }
  return nullptr;
}

void erase_entry(Handle* h, Entry* e);

Entry* insert_entry_once(Handle* h, const uint8_t* id) {
  Entry* t = table(h);
  uint64_t slots = h->hdr->table_slots;
  uint64_t i = hash_id(id) % slots;
  for (uint64_t probe = 0; probe < slots; ++probe) {
    Entry* e = &t[i];
    if (e->state == kFree) {
      memcpy(e->id, id, kIdSize);
      return e;
    }
    i = (i + 1) % slots;
  }
  return nullptr;  // table full
}

Entry* insert_entry(Handle* h, const uint8_t* id) {
  Entry* e = insert_entry_once(h, id);
  if (e) return e;
  // Table full: reclaim eviction tombstones (they exist only to fail lookups
  // fast; dropping them under table pressure is safe). erase_entry's cluster
  // re-insertion can relocate a not-yet-visited tombstone into an already-
  // scanned slot, so sweep until a full pass finds none.
  Entry* t = table(h);
  uint64_t slots = h->hdr->table_slots;
  bool erased_any = true;
  while (erased_any) {
    erased_any = false;
    for (uint64_t i = 0; i < slots; ++i) {
      if (t[i].state == kEvicted) {
        erase_entry(h, &t[i]);
        erased_any = true;
      }
    }
  }
  return insert_entry_once(h, id);
}

void erase_entry(Handle* h, Entry* e) {
  // Open addressing deletion: re-insert the rest of the cluster.
  Entry* t = table(h);
  uint64_t slots = h->hdr->table_slots;
  uint64_t i = e - t;
  e->state = kFree;
  uint64_t j = (i + 1) % slots;
  while (t[j].state != kFree) {
    Entry moved = t[j];
    t[j].state = kFree;
    Entry* dst = insert_entry(h, moved.id);
    uint8_t saved_id[kIdSize];
    memcpy(saved_id, moved.id, kIdSize);
    *dst = moved;
    memcpy(dst->id, saved_id, kIdSize);
    j = (j + 1) % slots;
  }
}

void clear_readers(Entry* e) {
  memset(e->reader_pid, 0, sizeof e->reader_pid);
  memset(e->reader_refs, 0, sizeof e->reader_refs);
}

// Count `delta` references for process `pid`. A reader with no slot free
// goes uncounted: its references are released by itself or never taken
// back, as before readers were counted.
void note_reader_locked(Entry* e, int32_t pid, int32_t delta) {
  int spare = -1;
  for (int i = 0; i < kReaders; ++i) {
    if (e->reader_refs[i] > 0 && e->reader_pid[i] == pid) {
      e->reader_refs[i] += delta;
      return;
    }
    if (e->reader_refs[i] <= 0 && spare < 0) spare = i;
  }
  if (delta > 0 && spare >= 0) {
    e->reader_pid[spare] = pid;
    e->reader_refs[spare] = delta;
  }
}

// True when process `pid` has ended: gone, or a zombie nobody has reaped
// yet (kill(pid, 0) still succeeds on one).
bool process_ended(int32_t pid) {
  if (kill(pid, 0) != 0) return errno == ESRCH;
  char path[64];
  snprintf(path, sizeof path, "/proc/%d/stat", (int)pid);
  FILE* f = fopen(path, "r");
  if (!f) return false;
  char buf[512];
  size_t n = fread(buf, 1, sizeof buf - 1, f);
  fclose(f);
  buf[n] = '\0';
  const char* p = strrchr(buf, ')');  // the state follows the command's ")"
  return p && p[1] == ' ' && p[2] == 'Z';
}

// Take back the references of reader process `pid`, which has ended.
void drop_reader_locked(Entry* e, int32_t pid) {
  for (int i = 0; i < kReaders; ++i) {
    if (e->reader_refs[i] > 0 && e->reader_pid[i] == pid) {
      e->refcnt -= e->reader_refs[i];
      if (e->refcnt < 0) e->refcnt = 0;
      e->reader_refs[i] = 0;
    }
  }
}

// Evict LRU sealed refcnt==0 objects until at least `need` bytes could fit.
// Returns 1 if anything was evicted.
int evict_locked(Handle* h, uint64_t need) {
  (void)need;
  Entry* t = table(h);
  uint64_t slots = h->hdr->table_slots;
  Entry* victim = nullptr;
  for (uint64_t i = 0; i < slots; ++i) {
    Entry* e = &t[i];
    if (e->state == kSealed && e->refcnt == 0) {
      if (!victim || e->lru_seq < victim->lru_seq) victim = e;
    }
  }
  if (!victim) return 0;
  h->hdr->stats.evictions++;
  h->hdr->stats.evicted_bytes += victim->size;
  free_locked(h, victim->offset);
  // Leave a tombstone instead of erasing: a live ObjectRef (or a stale GCS
  // location entry) may still point here, and a blocking get must see "lost",
  // not wait forever (ADVICE r1: eviction vs. live refs).
  victim->state = kEvicted;
  victim->offset = 0;
  victim->refcnt = 0;
  clear_readers(victim);
  return 1;
}

}  // namespace

extern "C" {

// Non-temporal bulk copy: streaming stores skip the read-for-ownership
// traffic a cached memcpy pays on the destination lines (~2x effective
// write bandwidth for large one-shot copies like object-store puts —
// the destination is shm another process reads, so polluting THIS
// core's cache with it is pure loss). x86-64 SSE2 baseline; other
// architectures fall back to memcpy.
void rt_copy_nt(void* dst, const void* src, uint64_t n) {
#if defined(__x86_64__) || defined(_M_X64)
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  // small copies + head up to 16B alignment: plain memcpy
  if (n < (1u << 16)) {
    memcpy(d, s, n);
    return;
  }
  uint64_t head = (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head) {
    memcpy(d, s, head);
    d += head;
    s += head;
    n -= head;
  }
  uint64_t vecs = n / 64;
  auto* dv = reinterpret_cast<__m128i*>(d);
  auto* sv = reinterpret_cast<const __m128i*>(s);
  for (uint64_t i = 0; i < vecs; ++i) {
    __m128i a = _mm_loadu_si128(sv + 4 * i + 0);
    __m128i b = _mm_loadu_si128(sv + 4 * i + 1);
    __m128i c = _mm_loadu_si128(sv + 4 * i + 2);
    __m128i e = _mm_loadu_si128(sv + 4 * i + 3);
    _mm_stream_si128(dv + 4 * i + 0, a);
    _mm_stream_si128(dv + 4 * i + 1, b);
    _mm_stream_si128(dv + 4 * i + 2, c);
    _mm_stream_si128(dv + 4 * i + 3, e);
  }
  _mm_sfence();
  uint64_t done = vecs * 64;
  if (done < n) memcpy(d + done, s + done, n - done);
#else
  memcpy(dst, src, n);
#endif
}

// Create a new store arena backed by /dev/shm/<name>. Returns handle or null.
void* rt_store_create(const char* name, uint64_t capacity) {
  // header + minimum 4096-slot table + one block of real space; anything
  // smaller underflows data_size and scribbles past the mapping.
  uint64_t min_capacity = align_up(sizeof(StoreHeader), kAlign) +
                          align_up(4096 * sizeof(Entry), kAlign) + (1u << 20);
  if (capacity < min_capacity) return nullptr;
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)capacity) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  auto* h = new Handle;
  h->base = static_cast<uint8_t*>(base);
  h->hdr = reinterpret_cast<StoreHeader*>(base);
  h->capacity = capacity;
  h->fd = fd;

  StoreHeader* s = h->hdr;
  memset(s, 0, sizeof(StoreHeader));
  s->capacity = capacity;
  // size the table at ~1 slot per 16KB of arena, min 4096 slots
  uint64_t slots = capacity / 16384;
  if (slots < 4096) slots = 4096;
  s->table_off = align_up(sizeof(StoreHeader), kAlign);
  s->table_slots = slots;
  s->data_off = align_up(s->table_off + slots * sizeof(Entry), kAlign);
  s->data_size = capacity - s->data_off;
  memset(h->base + s->table_off, 0, slots * sizeof(Entry));
  init_mutex(&s->mu);
  init_cond(&s->cv);
  // one giant free block
  uint8_t* data_base = h->base + s->data_off;
  write_block(data_base, reinterpret_cast<Block*>(data_base), s->data_size, 1);
  __sync_synchronize();
  s->magic = kMagic;
  return h;
}

void* rt_store_connect(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* h = new Handle;
  h->base = static_cast<uint8_t*>(base);
  h->hdr = reinterpret_cast<StoreHeader*>(base);
  h->capacity = st.st_size;
  h->fd = fd;
  if (h->hdr->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    delete h;
    return nullptr;
  }
  return h;
}

void rt_store_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  munmap(h->base, h->capacity);
  close(h->fd);
  delete h;
}

int rt_store_destroy(const char* name) { return shm_unlink(name); }

uint64_t rt_store_capacity(void* hv) {
  return static_cast<Handle*>(hv)->hdr->data_size;
}

uint64_t rt_store_bytes_in_use(void* hv) {
  return static_cast<Handle*>(hv)->hdr->bytes_in_use;
}

// Copy the arena stats block into out[0..n): field order matches
// StoreStats (creates, create_bytes, seals, gets, get_waits, get_lost,
// releases, deletes, evictions, evicted_bytes, peak_bytes). Locked copy
// (the caller is a ~1Hz metrics flush); returns fields written.
int rt_store_stats(void* hv, uint64_t* out, int n) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  if (lock(&s->mu) != 0) return 0;
  const uint64_t* src = reinterpret_cast<const uint64_t*>(&s->stats);
  int count = n < kStoreStatsFields ? n : kStoreStatsFields;
  for (int i = 0; i < count; i++) out[i] = src[i];
  pthread_mutex_unlock(&s->mu);
  return count;
}

// Enumerate spill candidates: sealed, unreferenced objects, LRU-first.
// Writes up to `max` ids (kIdSize bytes each) + sizes; returns the count.
// The raylet uses this to pick what to move to disk under arena pressure
// (the LocalObjectManager role, ref: local_object_manager.h:42).
int rt_store_list_spillable(void* hv, uint8_t* ids_out, uint64_t* sizes_out,
                            int max) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  lock(&s->mu);
  Entry* t = table(h);
  uint64_t slots = s->table_slots;
  // collect candidate slot indexes, then insertion-sort by lru_seq (max is
  // small — the raylet spills in bounded passes)
  int n = 0;
  struct Cand { uint64_t lru; uint64_t idx; };
  Cand* cands = new Cand[max];
  for (uint64_t i = 0; i < slots; ++i) {
    Entry* e = &t[i];
    if (e->state != kSealed || e->refcnt != 0) continue;
    Cand c{e->lru_seq, i};
    if (n < max) {
      int j = n++;
      while (j > 0 && cands[j - 1].lru > c.lru) { cands[j] = cands[j - 1]; --j; }
      cands[j] = c;
    } else if (cands[max - 1].lru > c.lru) {
      int j = max - 1;
      while (j > 0 && cands[j - 1].lru > c.lru) { cands[j] = cands[j - 1]; --j; }
      cands[j] = c;
    }
  }
  for (int k = 0; k < n; ++k) {
    Entry* e = &t[cands[k].idx];
    memcpy(ids_out + (uint64_t)k * kIdSize, e->id, kIdSize);
    sizes_out[k] = e->size;
  }
  delete[] cands;
  pthread_mutex_unlock(&s->mu);
  return n;
}

// Create an object; returns kOK and sets *offset_out (arena offset of data).
int rt_create(void* hv, const uint8_t* id, uint64_t size, uint64_t* offset_out) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  lock(&s->mu);
  Entry* existing = find_entry(h, id);
  if (existing && existing->state != kEvicted) {
    pthread_mutex_unlock(&s->mu);
    return kExists;
  }
  uint64_t off = alloc_locked(h, size);
  while (off == 0) {
    if (!evict_locked(h, size)) break;
    off = alloc_locked(h, size);
  }
  if (off == 0) {
    pthread_mutex_unlock(&s->mu);
    return kOutOfMemory;
  }
  // Resurrect an evicted id in place (lineage reconstruction re-creates the
  // same ObjectID); otherwise claim a fresh slot.
  Entry* e = existing ? existing : insert_entry(h, id);
  if (!e) {
    free_locked(h, off);
    pthread_mutex_unlock(&s->mu);
    return kOutOfMemory;
  }
  e->state = kCreated;
  e->offset = off;
  e->size = size;
  e->refcnt = 1;  // creator holds a ref until seal+release
  clear_readers(e);
  e->lru_seq = ++s->lru_clock;
  s->stats.creates++;
  s->stats.create_bytes += size;
  if (s->bytes_in_use > s->stats.peak_bytes)
    s->stats.peak_bytes = s->bytes_in_use;
  *offset_out = off;
  pthread_mutex_unlock(&s->mu);
  return kOK;
}

int rt_seal(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  if (chaos_seal_strike()) return kSysError;  // entry stays kCreated
  lock(&s->mu);
  Entry* e = find_entry(h, id);
  if (!e) {
    pthread_mutex_unlock(&s->mu);
    return kNotFound;
  }
  if (e->state != kCreated) {
    pthread_mutex_unlock(&s->mu);
    return kBadState;
  }
  e->state = kSealed;
  e->refcnt -= 1;  // drop creator ref
  e->lru_seq = ++s->lru_clock;
  s->stats.seals++;
  pthread_cond_broadcast(&s->cv);
  pthread_mutex_unlock(&s->mu);
  return kOK;
}

// Blocking get: waits until sealed or timeout; takes a reference.
int rt_get(void* hv, const uint8_t* id, int64_t timeout_ms, uint64_t* offset_out,
           uint64_t* size_out) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  timespec deadline;
  if (timeout_ms >= 0) deadline_after_ms(timeout_ms, &deadline);
  lock(&s->mu);
  for (;;) {
    Entry* e = find_entry(h, id);
    if (e && e->state == kSealed) {
      e->refcnt += 1;
      note_reader_locked(e, getpid(), 1);
      e->lru_seq = ++s->lru_clock;
      s->stats.gets++;
      *offset_out = e->offset;
      *size_out = e->size;
      pthread_mutex_unlock(&s->mu);
      return kOK;
    }
    if (e && e->state == kEvicted) {
      s->stats.get_lost++;
      pthread_mutex_unlock(&s->mu);
      return kLost;  // fail fast: caller raises ObjectLostError / reconstructs
    }
    int rc;
    s->stats.get_waits++;
    if (timeout_ms >= 0) {
      rc = cond_timedwait(&s->cv, &s->mu, &deadline);
      if (rc == ETIMEDOUT) {
        pthread_mutex_unlock(&s->mu);
        return kTimeout;
      }
    } else {
      rc = cond_wait(&s->cv, &s->mu);
    }
    if (rc != 0) {
      pthread_mutex_unlock(&s->mu);
      return kSysError;
    }
  }
}

// Non-blocking existence check; does NOT take a reference.
int rt_contains(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  lock(&h->hdr->mu);
  Entry* e = find_entry(h, id);
  int found = (e && e->state == kSealed) ? 1 : 0;
  pthread_mutex_unlock(&h->hdr->mu);
  return found;
}

int rt_release(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  lock(&h->hdr->mu);
  Entry* e = find_entry(h, id);
  if (!e) {
    pthread_mutex_unlock(&h->hdr->mu);
    return kNotFound;
  }
  if (e->refcnt > 0) e->refcnt -= 1;
  note_reader_locked(e, getpid(), -1);
  h->hdr->stats.releases++;
  pthread_cond_broadcast(&h->hdr->cv);
  pthread_mutex_unlock(&h->hdr->mu);
  return kOK;
}

// Delete: frees now if unreferenced, else marks for no new refs by erasing
// from the table once refcnt hits zero (here: spin is avoided — caller is the
// owner and release() of last ref frees the memory).
int rt_delete(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  lock(&h->hdr->mu);
  Entry* e = find_entry(h, id);
  if (!e) {
    pthread_mutex_unlock(&h->hdr->mu);
    return kNotFound;
  }
  // readers still holding references: those that have ended give them
  // back. Whether one has ended is asked outside the arena's lock (a
  // /proc read for each live one), then the entry is looked up again.
  int32_t pids[kReaders];
  int n = 0;
  if (e->state == kSealed && e->refcnt > 0) {
    for (int i = 0; i < kReaders; ++i)
      if (e->reader_refs[i] > 0) pids[n++] = e->reader_pid[i];
  }
  if (n > 0) {
    pthread_mutex_unlock(&h->hdr->mu);
    bool ended[kReaders];
    for (int j = 0; j < n; ++j) ended[j] = process_ended(pids[j]);
    lock(&h->hdr->mu);
    e = find_entry(h, id);
    if (!e) {
      pthread_mutex_unlock(&h->hdr->mu);
      return kNotFound;
    }
    for (int j = 0; j < n; ++j)
      if (ended[j]) drop_reader_locked(e, pids[j]);
  }
  if (e->state == kEvicted) {
    erase_entry(h, e);  // tombstone: data already freed
  } else if (e->refcnt <= 0) {
    free_locked(h, e->offset);
    erase_entry(h, e);
  } else {
    // keep data alive for readers; demote lru so eviction reclaims it next
    e->lru_seq = 0;
  }
  h->hdr->stats.deletes++;
  pthread_cond_broadcast(&h->hdr->cv);
  pthread_mutex_unlock(&h->hdr->mu);
  return kOK;
}

// ---- mutable channel objects (compiled-graph substrate) ----

int rt_chan_create(void* hv, const uint8_t* id, uint64_t size,
                   uint32_t num_readers, uint64_t* offset_out) {
  auto* h = static_cast<Handle*>(hv);
  StoreHeader* s = h->hdr;
  uint64_t total = align_up(sizeof(ChannelHeader), kAlign) + size;
  lock(&s->mu);
  if (find_entry(h, id)) {
    pthread_mutex_unlock(&s->mu);
    return kExists;
  }
  uint64_t off = alloc_locked(h, total);
  while (off == 0) {
    if (!evict_locked(h, total)) break;
    off = alloc_locked(h, total);
  }
  if (off == 0) {
    pthread_mutex_unlock(&s->mu);
    return kOutOfMemory;
  }
  Entry* e = insert_entry(h, id);
  if (!e) {
    free_locked(h, off);
    pthread_mutex_unlock(&s->mu);
    return kOutOfMemory;
  }
  e->state = kChannel;
  e->offset = off;
  e->size = size;
  e->refcnt = 1;
  clear_readers(e);
  e->lru_seq = ~0ull;  // never evict channels
  ChannelHeader* ch = reinterpret_cast<ChannelHeader*>(h->base + off);
  memset(ch, 0, sizeof(ChannelHeader));
  init_mutex(&ch->mu);
  init_cond(&ch->cv);
  ch->num_readers = num_readers;
  ch->readers_left = 0;
  ch->version = 0;
  *offset_out = off + align_up(sizeof(ChannelHeader), kAlign);
  pthread_mutex_unlock(&s->mu);
  return kOK;
}

// Copies the channel's arena offset/size out under the store mutex. Entry*
// must never be held across the unlock: erase_entry's open-addressing cluster
// re-insertion relocates entries, so a cached pointer can dangle (ADVICE r1).
// The *data* never moves — channels are never evicted — so the copied offset
// stays valid for the blocking waits below.
static int chan_lookup(Handle* h, const uint8_t* id, uint64_t* off_out,
                       uint64_t* size_out) {
  lock(&h->hdr->mu);
  Entry* e = find_entry(h, id);
  if (!e || e->state != kChannel) {
    pthread_mutex_unlock(&h->hdr->mu);
    return kNotFound;
  }
  *off_out = e->offset;
  if (size_out) *size_out = e->size;
  pthread_mutex_unlock(&h->hdr->mu);
  return kOK;
}

static ChannelHeader* chan_hdr_at(Handle* h, uint64_t off) {
  return reinterpret_cast<ChannelHeader*>(h->base + off);
}

int rt_chan_data(void* hv, const uint8_t* id, uint64_t* offset_out,
                 uint64_t* size_out) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, size_out);
  if (rc != kOK) return rc;
  *offset_out = off + align_up(sizeof(ChannelHeader), kAlign);
  return kOK;
}

// Writer: wait until all readers of the previous version have released.
int rt_chan_write_acquire(void* hv, const uint8_t* id, int64_t timeout_ms) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, nullptr);
  if (rc != kOK) return rc;
  ChannelHeader* ch = chan_hdr_at(h, off);
  timespec deadline;
  if (timeout_ms >= 0) deadline_after_ms(timeout_ms, &deadline);
  lock(&ch->mu);
  while (ch->readers_left > 0 && !ch->closed) {
    int w = timeout_ms >= 0 ? cond_timedwait(&ch->cv, &ch->mu, &deadline)
                            : cond_wait(&ch->cv, &ch->mu);
    if (w == ETIMEDOUT) {
      pthread_mutex_unlock(&ch->mu);
      return kTimeout;
    }
  }
  int closed = ch->closed;
  pthread_mutex_unlock(&ch->mu);
  return closed ? kClosed : kOK;
}

int rt_chan_write_release(void* hv, const uint8_t* id, uint64_t payload_size) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, nullptr);
  if (rc != kOK) return rc;
  ChannelHeader* ch = chan_hdr_at(h, off);
  lock(&ch->mu);
  ch->version += 1;
  ch->payload_size = payload_size;
  ch->readers_left = (int32_t)ch->num_readers;
  pthread_cond_broadcast(&ch->cv);
  pthread_mutex_unlock(&ch->mu);
  return kOK;
}

// Reader: wait for a version newer than last_version; returns it.
int rt_chan_read_acquire(void* hv, const uint8_t* id, uint64_t last_version,
                         int64_t timeout_ms, uint64_t* version_out,
                         uint64_t* payload_size_out) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, nullptr);
  if (rc != kOK) return rc;
  ChannelHeader* ch = chan_hdr_at(h, off);
  timespec deadline;
  if (timeout_ms >= 0) deadline_after_ms(timeout_ms, &deadline);
  lock(&ch->mu);
  while (ch->version <= last_version && !ch->closed) {
    int w = timeout_ms >= 0 ? cond_timedwait(&ch->cv, &ch->mu, &deadline)
                            : cond_wait(&ch->cv, &ch->mu);
    if (w == ETIMEDOUT) {
      pthread_mutex_unlock(&ch->mu);
      return kTimeout;
    }
  }
  if (ch->closed) {
    pthread_mutex_unlock(&ch->mu);
    return kClosed;
  }
  *version_out = ch->version;
  *payload_size_out = ch->payload_size;
  pthread_mutex_unlock(&ch->mu);
  return kOK;
}

int rt_chan_read_release(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, nullptr);
  if (rc != kOK) return rc;
  ChannelHeader* ch = chan_hdr_at(h, off);
  lock(&ch->mu);
  if (ch->readers_left > 0) ch->readers_left -= 1;
  pthread_cond_broadcast(&ch->cv);
  pthread_mutex_unlock(&ch->mu);
  return kOK;
}

int rt_chan_close(void* hv, const uint8_t* id) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t off;
  int rc = chan_lookup(h, id, &off, nullptr);
  if (rc != kOK) return rc;
  ChannelHeader* ch = chan_hdr_at(h, off);
  lock(&ch->mu);
  ch->closed = 1;
  pthread_cond_broadcast(&ch->cv);
  pthread_mutex_unlock(&ch->mu);
  return kOK;
}

// Runtime (re-)arm of the seal-failure chaos counter; 0 disarms.
void rt_store_chaos_set(uint64_t seal_fail_every) {
  __atomic_store_n(&g_chaos_seal_every, seal_fail_every, __ATOMIC_RELAXED);
  __atomic_store_n(&g_chaos_seal_ctr, 0, __ATOMIC_RELAXED);
}

}  // extern "C"
