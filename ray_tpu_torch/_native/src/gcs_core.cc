// Native GCS state engine: namespaced KV tables + write-ahead log +
// atomic snapshots, shared by the Python GCS server via ctypes.
//
// The role of the reference's GCS storage layer (ref:
// src/ray/gcs/gcs_server/store_client/redis_store_client.cc — there every
// table op journals through Redis; src/ray/gcs/gcs_server/gcs_table_storage.h
// per-table storage): here a single-process C++ engine the GCS process
// links in. Python keeps the *policy* (actor scheduling, health, pubsub
// fanout); the *state* — every KV byte, every journal append, every
// snapshot/recovery — lives native, with the GIL released for the
// entire operation.
//
// Durability model (identical semantics to the round-4 Python WAL, now
// binary + CRC):
//   - WAL record:  [u32 len][u32 crc32(payload)][payload]
//     payload:     [u8 type] type 1 = kv_put  [u16 nsl][ns][u32 kl][k][u32 vl][v]
//                            type 2 = kv_del  [u16 nsl][ns][u32 kl][k]
//                            type 3 = aux     [opaque bytes] (Python table op)
//   - replay stops at the first short/corrupt record (torn tail from a
//     kill mid-append) and truncates it away; every complete record is
//     applied. CRC catches partial page writes, not just short tails.
//   - snapshot: "RTGCS1\n" [u64 auxlen][aux blob] then
//     ([u16 nsl][ns][u32 kl][k][u32 vl][v])* — written tmp + rename
//     (atomic), after which the WAL truncates. The aux blob is Python's
//     pickled table state; opaque here.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---- crc32 (same polynomial as zlib; tiny table-driven impl) ----------
uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct GcsStore {
  std::mutex mu;
  // ns -> ordered key map (ordered: prefix scans stream in sorted order)
  std::unordered_map<std::string, std::map<std::string, std::string>> kv;
  std::string path;        // snapshot path ("" = volatile, no WAL)
  std::string wal_path;    // path + ".wal"
  FILE* wal = nullptr;     // append handle, lazily opened
  bool wal_broken = false; // unrecoverable write failure: snapshots only
  // aux records recovered from the WAL at open() — Python table ops to
  // replay on top of the snapshot's aux blob
  std::vector<std::string> recovered_aux;
  std::string snapshot_aux;  // aux blob from the snapshot file
  bool had_snapshot = false;
  uint64_t wal_records = 0;  // records applied during open()'s replay
  // opt-in machine-crash durability (rt_gcs_set_fsync): appends mark the
  // WAL dirty and rt_gcs_wal_sync group-commits them with one fdatasync;
  // snapshots fsync the tmp file before the rename and the directory
  // after it. Off (default) = fflush-only: survives a process kill (the
  // bytes are in the OS page cache) but not a machine crash.
  bool do_fsync = false;
  bool wal_dirty = false;  // appended since the last fdatasync
  // a record was dropped by the append-failure rewind: the in-memory
  // table is ahead of the WAL, so durability is broken until the next
  // snapshot captures the table (wal_sync reports -1 meanwhile)
  bool wal_lost = false;
};

void put_u16(std::string& out, uint16_t v) { out.append((const char*)&v, 2); }
void put_u32(std::string& out, uint32_t v) { out.append((const char*)&v, 4); }
void put_u64(std::string& out, uint64_t v) { out.append((const char*)&v, 8); }

bool rd(const uint8_t*& p, const uint8_t* end, void* out, size_t n) {
  if (p + n > end) return false;
  memcpy(out, p, n);
  p += n;
  return true;
}

// encode one WAL payload for a kv put/del
std::string enc_kv(uint8_t type, const std::string& ns, const std::string& k,
                   const std::string* v) {
  std::string p;
  p.push_back((char)type);
  put_u16(p, (uint16_t)ns.size());
  p += ns;
  put_u32(p, (uint32_t)k.size());
  p += k;
  if (v) {
    put_u32(p, (uint32_t)v->size());
    p += *v;
  }
  return p;
}

// append one record to the WAL; on write failure rewind to the record
// boundary (a partial record would poison every later append)
void wal_append(GcsStore* s, const std::string& payload) {
  if (s->path.empty() || s->wal_broken) return;
  if (!s->wal) {
    s->wal = fopen(s->wal_path.c_str(), "ab");
    if (!s->wal) { s->wal_broken = true; return; }
  }
  long pos = ftell(s->wal);
  uint32_t len = (uint32_t)payload.size();
  uint32_t crc = crc32((const uint8_t*)payload.data(), payload.size());
  if (fwrite(&len, 4, 1, s->wal) != 1 ||
      fwrite(&crc, 4, 1, s->wal) != 1 ||
      fwrite(payload.data(), 1, payload.size(), s->wal) != payload.size() ||
      fflush(s->wal) != 0) {
    if (pos >= 0 && ftruncate(fileno(s->wal), pos) == 0) {
      fseek(s->wal, pos, SEEK_SET);
      s->wal_lost = true;  // record dropped: not durable until snapshot
    } else {
      fclose(s->wal);
      s->wal = nullptr;
      s->wal_broken = true;
    }
    return;
  }
  s->wal_dirty = true;  // group commit: rt_gcs_wal_sync makes it durable
}

bool load_snapshot(GcsStore* s) {
  FILE* f = fopen(s->path.c_str(), "rb");
  if (!f) return false;
  char magic[7];
  if (fread(magic, 1, 7, f) != 7 || memcmp(magic, "RTGCS1\n", 7) != 0) {
    fclose(f);
    return false;
  }
  uint64_t auxlen = 0;
  if (fread(&auxlen, 8, 1, f) != 1) { fclose(f); return false; }
  s->snapshot_aux.resize(auxlen);
  if (auxlen && fread(&s->snapshot_aux[0], 1, auxlen, f) != auxlen) {
    fclose(f);
    s->snapshot_aux.clear();
    return false;
  }
  for (;;) {
    uint16_t nsl;
    if (fread(&nsl, 2, 1, f) != 1) break;  // clean EOF
    std::string ns(nsl, 0);
    uint32_t kl, vl;
    if ((nsl && fread(&ns[0], 1, nsl, f) != nsl) ||
        fread(&kl, 4, 1, f) != 1) break;
    std::string k(kl, 0);
    if ((kl && fread(&k[0], 1, kl, f) != kl) || fread(&vl, 4, 1, f) != 1)
      break;
    std::string v(vl, 0);
    if (vl && fread(&v[0], 1, vl, f) != vl) break;
    s->kv[ns][std::move(k)] = std::move(v);
  }
  fclose(f);
  s->had_snapshot = true;
  return true;
}

void replay_wal(GcsStore* s) {
  FILE* f = fopen(s->wal_path.c_str(), "rb");
  if (!f) return;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size > 0 ? (size_t)size : 0, 0);
  if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return;
  }
  fclose(f);
  const uint8_t* p = (const uint8_t*)buf.data();
  const uint8_t* end = p + buf.size();
  long good = 0;
  while (p + 8 <= end) {
    uint32_t len, crc;
    const uint8_t* rec_start = p;
    memcpy(&len, p, 4);
    memcpy(&crc, p + 4, 4);
    p += 8;
    if (p + len > end) { p = rec_start; break; }          // torn tail
    if (crc32(p, len) != crc) { p = rec_start; break; }   // corrupt record
    const uint8_t* q = p;
    const uint8_t* qend = p + len;
    p = qend;
    good = (long)(p - (const uint8_t*)buf.data());
    s->wal_records++;
    uint8_t type;
    if (!rd(q, qend, &type, 1)) continue;
    if (type == 3) {  // opaque Python table op
      s->recovered_aux.emplace_back((const char*)q, (size_t)(qend - q));
      continue;
    }
    uint16_t nsl;
    if (!rd(q, qend, &nsl, 2)) continue;
    std::string ns((const char*)q, 0);
    if (q + nsl > qend) continue;
    ns.assign((const char*)q, nsl);
    q += nsl;
    uint32_t kl;
    if (!rd(q, qend, &kl, 4) || q + kl > qend) continue;
    std::string k((const char*)q, kl);
    q += kl;
    if (type == 1) {
      uint32_t vl;
      if (!rd(q, qend, &vl, 4) || q + vl > qend) continue;
      s->kv[ns][std::move(k)].assign((const char*)q, vl);
    } else if (type == 2) {
      auto it = s->kv.find(ns);
      if (it != s->kv.end()) it->second.erase(k);
    }
  }
  // truncate any torn/corrupt tail so later appends start at a clean
  // record boundary. If NOTHING parsed, the file is either a previous
  // (pickle-framed) format or has a torn first record: sideline it as
  // .legacy — appends then start on a fresh file (never after garbage),
  // and the caller's migration path can inspect the sidelined bytes.
  if (good < size && good > 0) {
    if (truncate(s->wal_path.c_str(), good) != 0) { /* best effort */ }
  } else if (good == 0 && size > 0) {
    std::string legacy = s->wal_path + ".legacy";
    rename(s->wal_path.c_str(), legacy.c_str());
  }
}

// copy-out helper: -1 missing, -9 buffer too small (needed in *out_len),
// 0 copied
int copy_out(const std::string& v, uint8_t* buf, uint64_t buflen,
             uint64_t* out_len) {
  *out_len = v.size();
  if (v.size() > buflen) return -9;
  if (!v.empty()) memcpy(buf, v.data(), v.size());
  return 0;
}

}  // namespace

extern "C" {

void* rt_gcs_open(const char* path) {
  auto* s = new GcsStore();
  if (path && path[0]) {
    s->path = path;
    s->wal_path = s->path + ".wal";
    load_snapshot(s);
    replay_wal(s);
  }
  return s;
}

void rt_gcs_close(void* h) {
  auto* s = (GcsStore*)h;
  if (!s) return;
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->wal) fclose(s->wal);
  lk.unlock();
  delete s;
}

int rt_gcs_had_snapshot(void* h) {
  auto* s = (GcsStore*)h;
  return s->had_snapshot ? 1 : 0;
}

uint64_t rt_gcs_wal_records(void* h) {
  return ((GcsStore*)h)->wal_records;
}

// returns 1 stored, 0 exists-and-overwrite-false
int rt_gcs_kv_put(void* h, const char* ns, uint64_t nsl, const char* key,
                  uint64_t kl, const char* val, uint64_t vl, int overwrite,
                  int journal) {
  auto* s = (GcsStore*)h;
  std::string nss(ns, nsl), k(key, kl), v(val, vl);
  std::lock_guard<std::mutex> lk(s->mu);
  auto& table = s->kv[nss];
  auto it = table.find(k);
  if (it != table.end() && !overwrite) return 0;
  if (journal) wal_append(s, enc_kv(1, nss, k, &v));
  if (it != table.end())
    it->second = std::move(v);
  else
    table.emplace(std::move(k), std::move(v));
  return 1;
}

int rt_gcs_kv_get(void* h, const char* ns, uint64_t nsl, const char* key,
                  uint64_t kl, uint8_t* buf, uint64_t buflen,
                  uint64_t* out_len) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  auto nit = s->kv.find(std::string(ns, nsl));
  if (nit == s->kv.end()) return -1;
  auto it = nit->second.find(std::string(key, kl));
  if (it == nit->second.end()) return -1;
  return copy_out(it->second, buf, buflen, out_len);
}

int rt_gcs_kv_del(void* h, const char* ns, uint64_t nsl, const char* key,
                  uint64_t kl, int journal) {
  auto* s = (GcsStore*)h;
  std::string nss(ns, nsl), k(key, kl);
  std::lock_guard<std::mutex> lk(s->mu);
  if (journal) wal_append(s, enc_kv(2, nss, k, nullptr));
  auto nit = s->kv.find(nss);
  if (nit == s->kv.end()) return 0;
  return nit->second.erase(k) ? 1 : 0;
}

int rt_gcs_kv_exists(void* h, const char* ns, uint64_t nsl, const char* key,
                     uint64_t kl) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  auto nit = s->kv.find(std::string(ns, nsl));
  return nit != s->kv.end() && nit->second.count(std::string(key, kl)) ? 1 : 0;
}

// packs matching keys as ([u32 len][key])*; -9 + needed size if short
int rt_gcs_kv_keys(void* h, const char* ns, uint64_t nsl, const char* prefix,
                   uint64_t pl, uint8_t* buf, uint64_t buflen,
                   uint64_t* out_len) {
  auto* s = (GcsStore*)h;
  std::string pre(prefix, pl);
  std::lock_guard<std::mutex> lk(s->mu);
  auto nit = s->kv.find(std::string(ns, nsl));
  std::string packed;
  if (nit != s->kv.end()) {
    // ordered map: seek to the prefix and stream until it stops matching
    for (auto it = nit->second.lower_bound(pre); it != nit->second.end();
         ++it) {
      if (it->first.compare(0, pre.size(), pre) != 0) break;
      put_u32(packed, (uint32_t)it->first.size());
      packed += it->first;
    }
  }
  return copy_out(packed, buf, buflen, out_len);
}

uint64_t rt_gcs_kv_count(void* h, const char* ns, uint64_t nsl) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  auto nit = s->kv.find(std::string(ns, nsl));
  return nit == s->kv.end() ? 0 : nit->second.size();
}

// journal an opaque Python table op (type-3 aux record)
void rt_gcs_journal_aux(void* h, const char* payload, uint64_t len) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  std::string p;
  p.push_back((char)3);
  p.append(payload, len);
  wal_append(s, p);
}

int rt_gcs_wal_ok(void* h) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  return (!s->path.empty() && !s->wal_broken) ? 1 : 0;
}

// ---- opt-in durability (group-committed fdatasync) ---------------------
void rt_gcs_set_fsync(void* h, int on) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  s->do_fsync = on != 0;
}

// fdatasync the WAL iff records were appended since the last sync. The
// caller (Python group-commit barrier) batches: N writes acked in one
// event-loop tick share ONE disk sync. Returns 0 synced/clean, -1 error —
// including a broken WAL or a record dropped by the append-failure
// rewind: writes that never reached the WAL must surface as not-durable,
// not be silently acked (the next snapshot repairs/truncates the WAL and
// restores the guarantee). The fdatasync runs on a dup'd fd OUTSIDE the
// store mutex: a multi-millisecond disk sync under s->mu would block
// every concurrent kv operation (and the GCS event loop behind them).
int rt_gcs_wal_sync(void* h) {
  auto* s = (GcsStore*)h;
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (s->wal_broken || s->wal_lost) return -1;
    if (!s->wal_dirty || !s->wal) return 0;
    fd = dup(fileno(s->wal));  // survives a concurrent snapshot's fclose
    if (fd < 0) return -1;
    s->wal_dirty = false;
  }
  int rc = fdatasync(fd);
  close(fd);
  if (rc != 0) {
    std::lock_guard<std::mutex> lk(s->mu);
    s->wal_dirty = true;  // restore: the records are still unsynced
    return -1;
  }
  return 0;
}

// ---- recovery accessors ----------------------------------------------
int rt_gcs_snapshot_aux(void* h, uint8_t* buf, uint64_t buflen,
                        uint64_t* out_len) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  return copy_out(s->snapshot_aux, buf, buflen, out_len);
}

uint64_t rt_gcs_aux_count(void* h) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  return s->recovered_aux.size();
}

int rt_gcs_aux_get(void* h, uint64_t i, uint8_t* buf, uint64_t buflen,
                   uint64_t* out_len) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  if (i >= s->recovered_aux.size()) return -1;
  return copy_out(s->recovered_aux[i], buf, buflen, out_len);
}

// ---- snapshot ---------------------------------------------------------
// Writes tmp + rename (atomic), truncates the WAL, drops recovered aux.
// skip_ns: one namespace to leave out (volatile metrics), "" for none.
int rt_gcs_snapshot(void* h, const char* aux, uint64_t auxlen,
                    const char* skip_ns) {
  auto* s = (GcsStore*)h;
  std::lock_guard<std::mutex> lk(s->mu);
  if (s->path.empty()) return -1;
  std::string tmp = s->path + ".tmp" + std::to_string(getpid());
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -2;
  std::string skip = skip_ns ? skip_ns : "";
  bool ok = fwrite("RTGCS1\n", 1, 7, f) == 7 &&
            fwrite(&auxlen, 8, 1, f) == 1 &&
            (auxlen == 0 || fwrite(aux, 1, auxlen, f) == auxlen);
  for (auto& [ns, table] : s->kv) {
    if (!ok) break;
    if (!skip.empty() && ns == skip) continue;
    for (auto& [k, v] : table) {
      uint16_t nsl = (uint16_t)ns.size();
      uint32_t kl = (uint32_t)k.size(), vl = (uint32_t)v.size();
      ok = fwrite(&nsl, 2, 1, f) == 1 &&
           (nsl == 0 || fwrite(ns.data(), 1, nsl, f) == nsl) &&
           fwrite(&kl, 4, 1, f) == 1 &&
           (kl == 0 || fwrite(k.data(), 1, kl, f) == kl) &&
           fwrite(&vl, 4, 1, f) == 1 &&
           (vl == 0 || fwrite(v.data(), 1, vl, f) == vl);
      if (!ok) break;
    }
  }
  ok = (fflush(f) == 0) && ok;
  // machine-crash safety (opt-in): the tmp file's bytes must be on disk
  // BEFORE the rename makes it the live snapshot, or a crash could leave
  // a correctly-named file with garbage contents
  if (ok && s->do_fsync && fsync(fileno(f)) != 0) ok = false;
  fclose(f);
  if (!ok) {
    remove(tmp.c_str());
    return -3;
  }
  if (rename(tmp.c_str(), s->path.c_str()) != 0) {
    remove(tmp.c_str());
    return -4;
  }
  if (s->do_fsync) {
    // persist the rename itself: fsync the containing directory
    size_t slash = s->path.find_last_of('/');
    std::string dir = slash == std::string::npos ? "." : s->path.substr(0, slash);
    if (dir.empty()) dir = "/";
    int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
    if (dfd >= 0) {
      fsync(dfd);  // best effort: the data fsync above is the hard gate
      close(dfd);
    }
  }
  // state up to now is in the snapshot: the journal restarts empty
  if (s->wal) {
    fclose(s->wal);
    s->wal = nullptr;
  }
  remove(s->wal_path.c_str());
  s->wal_broken = false;
  s->wal_dirty = false;
  s->wal_lost = false;  // table state is in the snapshot: durable again
  s->recovered_aux.clear();
  s->snapshot_aux.assign(aux, auxlen);
  s->had_snapshot = true;
  return 0;
}

}  // extern "C"
