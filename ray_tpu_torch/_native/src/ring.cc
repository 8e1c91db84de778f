// Shared-memory task rings: the native transport for the steady-state
// task-submission fast path.
//
// Role in the design (ref: src/ray/core_worker/transport/
// normal_task_submitter.cc:28 + core_worker.cc:2500 — the reference's
// steady-state submit->lease-cache->push->reply loop runs entirely in
// C++): once a lease is cached, pushing a task and reading its reply
// should cost two memcpys, not an asyncio frame + socket syscall on each
// side. A RingPair is one POSIX shm segment holding two SPSC byte rings
// (submit: driver -> worker, reply: worker -> driver). Producers and
// consumers block on process-shared robust condvars only when the ring is
// full/empty; in steady state both sides stay awake and no syscalls are
// made. Records are [u32 len][payload] frames; the payload encoding is
// the Python layer's business.
//
// Crash-safety: mutexes are robust (EOWNERDEAD -> consistent), and either
// side can mark the ring closed; blocked peers wake with kClosed.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kRingMagic = 0x52545249'4e473145ull;  // "RTRING1E"

enum RingError : int {
  kOK = 0,
  kTimeout = -4,
  kClosed = -7,
  kTooBig = -9,
  kSys = -6,
};

// Per-direction counters, IN the shared segment so both sides read the
// same numbers (the Python layer surfaces them as rt_ring_* gauges —
// the metric_defs.cc stats-family role for the ring transport). Updated
// under the ring mutex: plain adds, no extra atomics on the hot path.
struct RingStats {
  uint64_t push_ops;        // native push calls that moved >= 1 byte
  uint64_t push_bytes;
  uint64_t push_records;    // framed records pushed (where the call can tell)
  uint64_t pop_ops;         // pop calls that returned >= 1 record
  uint64_t pop_bytes;
  uint64_t pop_records;
  uint64_t producer_waits;  // futex sleeps while full (the "full" events)
  uint64_t consumer_waits;  // futex sleeps while empty
  uint64_t wake_signals;    // broadcasts actually issued (waiters != 0)
  uint64_t spin_hits;       // consumer spin found data without sleeping
  uint64_t partial_pushes;  // push_batch couldn't take the whole buffer
  uint64_t peak_used;       // max observed occupancy (bytes)
};
constexpr int kRingStatsFields = sizeof(RingStats) / sizeof(uint64_t);

struct Ring {
  pthread_mutex_t mu;
  pthread_cond_t cv;      // broadcast on push, pop and close
  uint64_t capacity;      // data area bytes
  uint64_t head;          // total bytes ever written (producer cursor)
  uint64_t tail;          // total bytes ever read (consumer cursor)
  uint32_t closed;
  uint32_t waiters;       // threads inside cond_wait (under mu)
  uint64_t data_off;      // data area offset from segment base
  RingStats stats;
};

struct PairHeader {
  uint64_t magic;
  uint64_t total_size;
  Ring sub;   // driver -> worker
  Ring rep;   // worker -> driver
};

struct RingHandle {
  PairHeader* hdr;
  uint8_t* base;
  uint64_t total;
  int fd;
};

uint64_t align_up(uint64_t n, uint64_t a) { return (n + a - 1) & ~(a - 1); }

// ---------------------------------------------------------------------------
// Chaos fault arms (devtools/chaos): env-gated counters that force the rare
// ring conditions — partial batch pushes and wait timeouts — on a fixed
// cadence, so the Python recovery paths (flush retry from the consumed
// prefix, RPC spill, lane break) are exercised below the Python layer.
// Disarmed (the default) the cost is one relaxed load of a zero. Armed via
// RT_CHAOS_RING_*_EVERY at dlopen (spawned workers inherit the env) or
// rt_ring_chaos_set at runtime. Counters are atomics: the arms must not
// introduce a data race the TSAN matrix would (rightly) flag.
uint64_t env_every(const char* name) {
  const char* raw = getenv(name);
  if (!raw) return 0;
  char* end = nullptr;
  unsigned long long v = strtoull(raw, &end, 10);
  return (end && *end == '\0') ? (uint64_t)v : 0;
}

uint64_t g_chaos_partial_every = env_every("RT_CHAOS_RING_PARTIAL_EVERY");
uint64_t g_chaos_timeout_every = env_every("RT_CHAOS_RING_TIMEOUT_EVERY");
uint64_t g_chaos_partial_ctr = 0;
uint64_t g_chaos_timeout_ctr = 0;

// true on every Nth call while armed
bool chaos_strike(uint64_t* every_p, uint64_t* ctr) {
  uint64_t every = __atomic_load_n(every_p, __ATOMIC_RELAXED);
  if (every == 0) return false;
  return __atomic_add_fetch(ctr, 1, __ATOMIC_RELAXED) % every == 0;
}

int lock(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

void init_sync(pthread_mutex_t* mu, pthread_cond_t* cv) {
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(mu, &ma);
  pthread_mutexattr_destroy(&ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(cv, &ca);
  pthread_condattr_destroy(&ca);
}

// Wake sleepers only after the mutex is released, and only if there are
// any: broadcasting while holding the lock on a single-core host preempts
// the signaler into a woken thread that instantly blocks on the held
// mutex (two extra context switches per record); and in the spin-paired
// steady state nobody sleeps at all, so the futex syscall is skipped
// entirely.
void unlock_and_wake(Ring* r) {
  uint32_t waiters = r->waiters;
  if (waiters != 0) r->stats.wake_signals++;  // still under mu
  pthread_mutex_unlock(&r->mu);
  if (waiters != 0) pthread_cond_broadcast(&r->cv);
}

// Producer-side occupancy bookkeeping, called under mu after advancing head.
void note_push(Ring* r, uint64_t bytes, uint64_t records) {
  RingStats* st = &r->stats;
  st->push_ops++;
  st->push_bytes += bytes;
  st->push_records += records;
  uint64_t used = r->head - r->tail;
  if (used > st->peak_used) st->peak_used = used;
}

int timed_wait(Ring* r, int64_t timeout_ms) {
  pthread_cond_t* cv = &r->cv;
  pthread_mutex_t* mu = &r->mu;
  r->waiters++;
  int rc;
  if (timeout_ms < 0) {
    rc = pthread_cond_wait(cv, mu);
  } else {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
      ts.tv_sec += 1;
      ts.tv_nsec -= 1000000000L;
    }
    rc = pthread_cond_timedwait(cv, mu, &ts);
  }
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  r->waiters--;
  return rc;
}

Ring* ring_of(RingHandle* h, int which) {
  return which == 0 ? &h->hdr->sub : &h->hdr->rep;
}

// Opportunistic spin before a futex sleep: on a busy ring the next record
// lands within microseconds, and a shared-futex sleep/wake round measured
// 60-90us per side here (vs ~1us for a yield). sched_yield (rather than a
// pause loop) matters on single-core hosts: it hands the core to the peer
// instead of burning the timeslice it needs — and while the consumer
// spins its `waiters` stays 0, so the producer skips ITS wake syscall
// too: a fast round trip (the completion lane's submit->execute->reply
// ping-pong) can close with zero futex calls on either side. 64
// iterations spans the peer's turnaround for a small task (each yield
// hands it a scheduler slice); an idle ring still reaches the futex
// sleep after ~65 yields, which return immediately when nothing else is
// runnable, so parked consumers stay cheap. Returns true if the
// condition became true without sleeping.
template <typename F>
bool spin_for(F cond) {
  for (int i = 0; i < 64; i++) {
    if (cond()) return true;
    sched_yield();
  }
  return cond();
}

void copy_in(uint8_t* data, uint64_t cap, uint64_t pos, const uint8_t* src,
             uint64_t len) {
  uint64_t off = pos % cap;
  uint64_t first = cap - off;
  if (first >= len) {
    memcpy(data + off, src, len);
  } else {
    memcpy(data + off, src, first);
    memcpy(data, src + first, len - first);
  }
}

void copy_out(const uint8_t* data, uint64_t cap, uint64_t pos, uint8_t* dst,
              uint64_t len) {
  uint64_t off = pos % cap;
  uint64_t first = cap - off;
  if (first >= len) {
    memcpy(dst, data + off, len);
  } else {
    memcpy(dst, data + off, first);
    memcpy(dst + first, data, len - first);
  }
}

}  // namespace

extern "C" {

// Create the segment (driver side). cap_each is the data capacity of EACH
// direction's ring. Returns NULL on failure.
void* rt_ring_pair_create(const char* name, uint64_t cap_each) {
  cap_each = align_up(cap_each, 64);
  uint64_t hdr_sz = align_up(sizeof(PairHeader), 64);
  uint64_t total = hdr_sz + 2 * cap_each;
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = (PairHeader*)mem;
  memset(hdr, 0, sizeof(PairHeader));
  hdr->total_size = total;
  hdr->sub.capacity = cap_each;
  hdr->sub.data_off = hdr_sz;
  hdr->rep.capacity = cap_each;
  hdr->rep.data_off = hdr_sz + cap_each;
  init_sync(&hdr->sub.mu, &hdr->sub.cv);
  init_sync(&hdr->rep.mu, &hdr->rep.cv);
  __atomic_store_n(&hdr->magic, kRingMagic, __ATOMIC_RELEASE);
  auto* h = new RingHandle{hdr, (uint8_t*)mem, total, fd};
  return h;
}

void* rt_ring_pair_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(PairHeader)) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* hdr = (PairHeader*)mem;
  if (__atomic_load_n(&hdr->magic, __ATOMIC_ACQUIRE) != kRingMagic ||
      hdr->total_size != (uint64_t)st.st_size) {
    munmap(mem, st.st_size);
    close(fd);
    return nullptr;
  }
  auto* h = new RingHandle{hdr, (uint8_t*)mem, (uint64_t)st.st_size, fd};
  return h;
}

// Push one [u32 len][payload] record; blocks while full. which: 0=sub 1=rep.
int rt_ring_push(void* hp, int which, const uint8_t* buf, uint64_t len,
                 int64_t timeout_ms) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  if (chaos_strike(&g_chaos_timeout_every, &g_chaos_timeout_ctr))
    return kTimeout;  // forced "ring stayed full": caller retries/spills
  uint64_t need = align_up(4 + len, 8);
  if (need > r->capacity) return kTooBig;
  uint8_t* data = h->base + r->data_off;
  if (lock(&r->mu) != 0) return kSys;
  while (true) {
    if (r->closed) {
      pthread_mutex_unlock(&r->mu);
      return kClosed;
    }
    if (r->capacity - (r->head - r->tail) >= need) break;
    r->stats.producer_waits++;
    int rc = timed_wait(r, timeout_ms);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&r->mu);
      return kTimeout;
    }
    if (rc != 0) {
      pthread_mutex_unlock(&r->mu);
      return kSys;
    }
  }
  uint32_t len32 = (uint32_t)len;
  copy_in(data, r->capacity, r->head, (const uint8_t*)&len32, 4);
  copy_in(data, r->capacity, r->head + 4, buf, len);
  __atomic_store_n(&r->head, r->head + need, __ATOMIC_RELEASE);
  note_push(r, need, 1);
  unlock_and_wake(r);
  return kOK;
}

// Push a buffer that already contains N framed records, atomically w.r.t.
// interleaving with this producer's other pushes (it is SPSC, so that just
// means one lock round). Blocks until all of it fits.
int rt_ring_push_raw(void* hp, int which, const uint8_t* buf, uint64_t len,
                     int64_t timeout_ms) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  uint64_t need = len;  // caller pre-aligned: every record align_up(4+n,8)
  if (need > r->capacity) return kTooBig;
  uint8_t* data = h->base + r->data_off;
  if (lock(&r->mu) != 0) return kSys;
  while (true) {
    if (r->closed) {
      pthread_mutex_unlock(&r->mu);
      return kClosed;
    }
    if (r->capacity - (r->head - r->tail) >= need) break;
    r->stats.producer_waits++;
    int rc = timed_wait(r, timeout_ms);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&r->mu);
      return kTimeout;
    }
    if (rc != 0) {
      pthread_mutex_unlock(&r->mu);
      return kSys;
    }
  }
  copy_in(data, r->capacity, r->head, buf, len);
  __atomic_store_n(&r->head, r->head + need, __ATOMIC_RELEASE);
  note_push(r, need, 0);  // caller-framed: record count unknown here
  unlock_and_wake(r);
  return kOK;
}

// Push as many whole framed records from buf[0..len) as currently fit,
// waiting up to timeout_ms for space for the FIRST record only. buf holds
// N records in rt_ring_push_raw framing ([u32 len][payload], 8-aligned).
// Returns bytes consumed (0 on timeout — nothing was pushed), or a
// negative RingError. The coalesced-flush path uses this to drain a
// driver-side submit buffer in ONE lock round + at most one consumer
// wake per call, and to push partial prefixes instead of blocking the
// submitting thread when the ring is nearly full.
int64_t rt_ring_push_batch(void* hp, int which, const uint8_t* buf,
                           uint64_t len, int64_t timeout_ms) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  if (len < 4) return 0;
  uint32_t len32;
  memcpy(&len32, buf, 4);
  uint64_t first = align_up(4 + (uint64_t)len32, 8);
  if (first > r->capacity) return kTooBig;
  uint8_t* data = h->base + r->data_off;
  if (lock(&r->mu) != 0) return kSys;
  while (true) {
    if (r->closed) {
      pthread_mutex_unlock(&r->mu);
      return kClosed;
    }
    if (r->capacity - (r->head - r->tail) >= first) break;
    r->stats.producer_waits++;
    int rc = timed_wait(r, timeout_ms);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&r->mu);
      return 0;
    }
    if (rc != 0) {
      pthread_mutex_unlock(&r->mu);
      return kSys;
    }
  }
  uint64_t avail = r->capacity - (r->head - r->tail);
  if (chaos_strike(&g_chaos_partial_every, &g_chaos_partial_ctr))
    avail = first;  // forced partial: only the head record fits this call
  uint64_t take = 0;
  uint64_t nrecs = 0;
  while (take + 4 <= len) {
    memcpy(&len32, buf + take, 4);
    uint64_t rec = align_up(4 + (uint64_t)len32, 8);
    if (take + rec > len || take + rec > avail) break;
    take += rec;
    nrecs++;
  }
  copy_in(data, r->capacity, r->head, buf, take);
  __atomic_store_n(&r->head, r->head + take, __ATOMIC_RELEASE);
  if (take) note_push(r, take, nrecs);
  if (take < len) r->stats.partial_pushes++;
  unlock_and_wake(r);
  return (int64_t)take;
}

// Pop as many whole records as fit into out[outcap]; blocks until at least
// one record is available (or timeout/closed). Returns total bytes written
// to out (still [u32 len][payload] framed, 8-aligned), 0 on timeout, or a
// negative RingError. kClosed is only returned once the ring is drained.
int64_t rt_ring_pop_batch(void* hp, int which, uint8_t* out, uint64_t outcap,
                          int64_t timeout_ms) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  if (chaos_strike(&g_chaos_timeout_every, &g_chaos_timeout_ctr))
    return 0;  // forced empty-wait timeout: consumer loops back around
  uint8_t* data = h->base + r->data_off;
  bool spun = spin_for([r] {
    return __atomic_load_n(&r->head, __ATOMIC_ACQUIRE) !=
               __atomic_load_n(&r->tail, __ATOMIC_RELAXED) ||
           __atomic_load_n(&r->closed, __ATOMIC_RELAXED);
  });
  if (lock(&r->mu) != 0) return kSys;
  if (spun && r->head != r->tail) r->stats.spin_hits++;
  while (r->head == r->tail) {
    if (r->closed) {
      pthread_mutex_unlock(&r->mu);
      return kClosed;
    }
    r->stats.consumer_waits++;
    int rc = timed_wait(r, timeout_ms);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&r->mu);
      return 0;
    }
    if (rc != 0) {
      pthread_mutex_unlock(&r->mu);
      return kSys;
    }
  }
  uint64_t written = 0;
  uint64_t nrecs = 0;
  while (r->head != r->tail) {
    uint32_t len32;
    copy_out(data, r->capacity, r->tail, (uint8_t*)&len32, 4);
    uint64_t rec = align_up(4 + (uint64_t)len32, 8);
    if (written + rec > outcap) {
      if (written == 0) {
        // head record alone exceeds the caller's buffer: returning 0
        // would look like a timeout forever — surface a hard error so
        // the caller tears the ring down instead of spinning
        pthread_mutex_unlock(&r->mu);
        return kTooBig;
      }
      break;
    }
    copy_out(data, r->capacity, r->tail, out + written, rec);
    __atomic_store_n(&r->tail, r->tail + rec, __ATOMIC_RELEASE);
    written += rec;
    nrecs++;
  }
  RingStats* st = &r->stats;
  st->pop_ops++;
  st->pop_bytes += written;
  st->pop_records += nrecs;
  unlock_and_wake(r);
  return (int64_t)written;
}

// Copy one direction's stats block into out[0..n): field order matches
// RingStats (push_ops, push_bytes, push_records, pop_ops, pop_bytes,
// pop_records, producer_waits, consumer_waits, wake_signals, spin_hits,
// partial_pushes, peak_used). Returns the number of fields written.
// Takes the ring mutex: the caller is a ~1Hz metrics flush, and a
// locked copy keeps the counters race-free (TSAN matrix) without
// putting any atomics on the push/pop hot path.
int rt_ring_stats(void* hp, int which, uint64_t* out, int n) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  if (lock(&r->mu) != 0) return 0;
  const uint64_t* src = (const uint64_t*)&r->stats;
  int count = n < kRingStatsFields ? n : kRingStatsFields;
  for (int i = 0; i < count; i++) out[i] = src[i];
  pthread_mutex_unlock(&r->mu);
  return count;
}

// Bytes currently queued in one direction (approximate: unlocked read).
uint64_t rt_ring_pending(void* hp, int which) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  return r->head - r->tail;
}

void rt_ring_close(void* hp, int which) {
  auto* h = (RingHandle*)hp;
  Ring* r = ring_of(h, which);
  if (lock(&r->mu) == 0) {
    // atomic store: rt_ring_pop_batch's pre-lock spin and rt_ring_closed
    // read `closed` without the mutex, so the write must be atomic too
    // (mixed plain/atomic access to one location is UB and a TSAN race)
    __atomic_store_n(&r->closed, 1, __ATOMIC_RELEASE);
    pthread_cond_broadcast(&r->cv);
    pthread_mutex_unlock(&r->mu);
  }
}

int rt_ring_closed(void* hp, int which) {
  auto* h = (RingHandle*)hp;
  return (int)__atomic_load_n(&ring_of(h, which)->closed, __ATOMIC_ACQUIRE);
}

void rt_ring_pair_close(void* hp) {
  auto* h = (RingHandle*)hp;
  munmap(h->base, h->total);
  close(h->fd);
  delete h;
}

void rt_ring_pair_destroy(const char* name) { shm_unlink(name); }

// Runtime (re-)arm of the chaos fault counters; 0 disarms. The env path
// (RT_CHAOS_RING_PARTIAL_EVERY / RT_CHAOS_RING_TIMEOUT_EVERY at dlopen)
// serves spawned processes; this serves a library already loaded.
void rt_ring_chaos_set(uint64_t partial_every, uint64_t timeout_every) {
  __atomic_store_n(&g_chaos_partial_every, partial_every, __ATOMIC_RELAXED);
  __atomic_store_n(&g_chaos_timeout_every, timeout_every, __ATOMIC_RELAXED);
  __atomic_store_n(&g_chaos_partial_ctr, 0, __ATOMIC_RELAXED);
  __atomic_store_n(&g_chaos_timeout_ctr, 0, __ATOMIC_RELAXED);
}

}  // extern "C"
