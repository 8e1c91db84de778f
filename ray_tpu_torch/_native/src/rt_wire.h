// rt_wire.h — shared wire helpers for native peers (worker + client):
// blocking TCP framing (<u64 LE len><pickle>), dialing, and the packed
// value layout of serialization.pack (u32 meta-len | pickled (sizes,
// header) | 64-byte-aligned buffers).
#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <string>

#include "picklite.h"

namespace rt {
namespace wire {

// Wire-schema version; must match ray_tpu_torch/utils/schema.py PROTOCOL_VERSION
// (tests/test_wire_schema.py cross-checks the two).
constexpr int kProtocolMajor = 2;
constexpr int kProtocolMinor = 3;

// ---------------------------------------------------------------------
// Fastpath record catalog (shm rings + node tunnels, core/fastpath.py).
// Every prefix byte and reply-status flag a native peer may see on a
// record stream MUST appear here AND in utils/schema.py
// (RECORD_PREFIXES / RECORD_FLAGS) — tests/test_wire_schema.py parses
// this block and asserts byte-for-byte parity in both directions, so a
// shipped-but-uncataloged wire entry is a tier-1 failure by
// construction.
constexpr char kRecPrefixTaskPickle = 'P';   // task, C-pickled, no stamp
constexpr char kRecPrefixTaskPacked = 'S';   // task, serialization.pack
constexpr char kRecPrefixTaskPickleTs = 'Q'; // task, C-pickled + u64 stamp
constexpr char kRecPrefixTaskPackedTs = 'R'; // task, packed + u64 stamp
constexpr char kRecPrefixActorPickle = 'A';  // actor, C-pickled + seq hdr
constexpr char kRecPrefixActorPacked = 'C';  // actor, packed + seq hdr
constexpr char kRecPrefixChunk = 'G';        // stream chunk (2.3): 'A'
// header shape (seq slot = per-stream chunk index, same trace bit),
// body <16s task_id><u32 status> + payload
constexpr uint32_t kReplyFlagStamped = 0x100;  // 16-byte stage stamp follows
constexpr uint32_t kReplyFlagSeqed = 0x200;    // u32 echoed seq follows
constexpr uint32_t kReplyFlagTraced = 0x400;   // 25-byte trace leg follows
// Reply status CODES (low bits below the flag bits), cataloged since
// 2.3 — utils/schema.py RECORD_STATUS mirrors these.
constexpr uint32_t kReplyStatusOk = 0;        // payload = packed value
constexpr uint32_t kReplyStatusOkShm = 1;     // sealed in the node arena
constexpr uint32_t kReplyStatusErr = 2;       // payload = pickled error
constexpr uint32_t kReplyStatusNeedSlow = 3;  // declined: RPC path owns it
constexpr uint32_t kReplyStatusChunk = 4;     // 'G' only: inline item
constexpr uint32_t kReplyStatusChunkShm = 5;  // 'G' only: sealed item
// Record-side trace flag (2.1): bit 63 of the u64 t_submit field of
// "Q"/"R"/"A"/"C" records — set = a 25-byte trace leg
// (<16s trace_id><8s span_id><u8 sampled>) follows the record header.
constexpr uint64_t kRecordTraceCtxBit = 1ULL << 63;
constexpr size_t kTraceCtxLen = 25;

inline bool read_exact(int fd, void* buf, size_t n) {
  auto* p = (char*)buf;
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

inline bool write_all(int fd, const void* buf, size_t n) {
  auto* p = (const char*)buf;
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

inline bool read_frame(int fd, std::string* out) {
  uint64_t len;
  if (!read_exact(fd, &len, 8)) return false;
  if (len > (1ULL << 33)) return false;  // sanity: 8 GiB frame cap
  out->resize(len);
  return read_exact(fd, out->data(), len);
}

inline bool write_frame(int fd, const std::string& payload) {
  uint64_t len = payload.size();
  std::string buf;
  buf.reserve(8 + payload.size());
  buf.append((const char*)&len, 8);
  buf.append(payload);
  return write_all(fd, buf.data(), buf.size());
}

inline int dial(const std::string& host, int port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    // not a numeric address: resolve via getaddrinfo
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (::getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
      return -1;
    addr.sin_addr = ((sockaddr_in*)res->ai_addr)->sin_addr;
    ::freeaddrinfo(res);
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

constexpr size_t kAlign = 64;  // serialization._ALIGN

inline size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

// serialization.pack layout -> value tree
inline picklite::ValuePtr unpack_value(const std::string& packed) {
  using picklite::Value;
  if (packed.size() < 4) throw picklite::Error("short packed value");
  uint32_t meta_len;
  std::memcpy(&meta_len, packed.data(), 4);
  if (4 + (size_t)meta_len > packed.size()) throw picklite::Error("bad meta len");
  auto meta = picklite::loads(packed.substr(4, meta_len));
  if (meta->kind != Value::kTuple || meta->items.size() != 2)
    throw picklite::Error("bad meta tuple");
  auto& sizes = meta->items[0];
  auto& header = meta->items[1];
  std::vector<std::string> buffers;
  size_t off = 4 + meta_len;
  for (auto& sz : sizes->items) {
    off = align_up(off);
    size_t n = (size_t)sz->i;
    if (off + n > packed.size()) throw picklite::Error("buffer overrun");
    buffers.push_back(packed.substr(off, n));
    off += n;
  }
  return picklite::loads(header->s, std::move(buffers));
}

// value tree -> serialization.pack layout (no out-of-band buffers)
inline std::string pack_value(const picklite::Value& v) {
  using picklite::Value;
  std::string header = picklite::dumps(v);
  Value meta;
  meta.kind = Value::kTuple;
  meta.items.push_back(Value::list());
  meta.items.push_back(Value::bytes(header));
  std::string meta_b = picklite::dumps(meta);
  std::string packed;
  uint32_t meta_len = (uint32_t)meta_b.size();
  packed.append((const char*)&meta_len, 4);
  packed.append(meta_b);
  return packed;
}

}  // namespace wire
}  // namespace rt
