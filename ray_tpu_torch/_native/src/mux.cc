// Native RPC server mux: an epoll thread owns the listen socket and every
// client connection; Python sees batched, already-framed messages.
//
// The role of the reference's gRPC server event loops (ref:
// src/ray/rpc/grpc_server.h:88 — N completion-queue threads drain all
// client connections off the Python/handler thread): under fan-in, the
// asyncio transport spends more time resuming per-connection reader
// coroutines and creating per-frame tasks than running handlers. Here:
//
//   - one C++ epoll thread accepts, reads [u64 len][payload] frames from
//     every connection, and appends records to a shared in-queue; an
//     eventfd wakes Python ONCE per burst (level-triggered read side),
//   - Python drains the whole burst in a single callback
//     (rt_mux_recv_batch), dispatching handlers with zero asyncio
//     Stream machinery,
//   - replies (rt_mux_send) try an immediate non-blocking send() on the
//     caller's thread — one syscall, no hop — and spill the remainder to
//     a per-conn out-buffer flushed by the epoll thread on EPOLLOUT.
//
// Record batch format (rt_mux_recv_batch):
//   [u64 conn_id][u32 type][u32 len][payload]*
//   type 0 = frame payload, 1 = connected (len 0), 2 = disconnected (len 0)

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <fcntl.h>
#include <cstring>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>

namespace {

constexpr uint64_t kMaxFrame = 1ull << 32;      // 4GB sanity cap
constexpr size_t kMaxOutBuf = 256ull << 20;     // per-conn write backlog cap
constexpr size_t kReadChunk = 256 * 1024;

struct Conn {
  int fd;
  uint64_t id;
  std::string inbuf;        // unparsed read bytes
  std::mutex out_mu;
  std::string outbuf;       // pending write bytes (after partial sends)
  bool want_epollout = false;
  bool dead = false;
};

struct Record {
  uint64_t conn_id;
  uint32_t type;
  std::string payload;
};

struct Mux {
  int listen_fd = -1;
  int epfd = -1;
  int ready_efd = -1;   // signals Python: records available
  int wake_efd = -1;    // wakes the epoll thread (sends, stop)
  uint16_t port = 0;
  std::thread thr;
  std::mutex mu;        // guards conns, inq, next_id, stopping
  std::unordered_map<uint64_t, Conn*> conns;
  std::deque<Record> inq;
  uint64_t next_id = 1;
  bool stopping = false;
};

void push_record(Mux* m, uint64_t id, uint32_t type, std::string payload) {
  bool was_empty;
  {
    std::lock_guard<std::mutex> lk(m->mu);
    was_empty = m->inq.empty();
    m->inq.push_back({id, type, std::move(payload)});
  }
  if (was_empty) {
    uint64_t one = 1;
    ssize_t r = write(m->ready_efd, &one, 8);
    (void)r;
  }
}

void epoll_update(Mux* m, Conn* c) {
  epoll_event ev{};
  ev.events = EPOLLIN | (c->want_epollout ? EPOLLOUT : 0);
  ev.data.u64 = c->id;
  epoll_ctl(m->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

void drop_conn(Mux* m, Conn* c) {
  if (c->dead) return;
  c->dead = true;
  epoll_ctl(m->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  // do NOT close(fd) here: rt_mux_send on the Python loop thread may be
  // inside its send() loop on this very fd, and closing would let the
  // kernel reassign the number to a newly accepted connection — a reply
  // meant for this peer would land in another client's stream. shutdown
  // makes every pending/future send fail without freeing the number;
  // the fd closes in rt_mux_release, which Python only calls AFTER the
  // disconnect record was processed on the same thread all sends run on.
  shutdown(c->fd, SHUT_RDWR);
  push_record(m, c->id, 2, "");
  // the Conn object stays in the map (tombstone) until Python calls
  // rt_mux_release — sends to a dead id fail cleanly, never use-after-free
}

// parse complete frames out of c->inbuf
void parse_frames(Mux* m, Conn* c) {
  size_t off = 0;
  while (c->inbuf.size() - off >= 8) {
    uint64_t len;
    memcpy(&len, c->inbuf.data() + off, 8);
    if (len >= kMaxFrame) {  // protocol violation: hang up (>= : a frame
                             // of exactly 2^32 would wrap the u32 batch
                             // header length and desync the drain parser)
      drop_conn(m, c);
      return;
    }
    if (c->inbuf.size() - off - 8 < len) break;
    push_record(m, c->id, 0, c->inbuf.substr(off + 8, len));
    off += 8 + len;
  }
  if (off) c->inbuf.erase(0, off);
}

void handle_readable(Mux* m, Conn* c) {
  char buf[kReadChunk];
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c->inbuf.append(buf, (size_t)n);
      if ((size_t)n < sizeof(buf)) break;
    } else if (n == 0) {
      parse_frames(m, c);
      drop_conn(m, c);
      return;
    } else {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      drop_conn(m, c);
      return;
    }
  }
  parse_frames(m, c);
}

void handle_writable(Mux* m, Conn* c) {
  std::lock_guard<std::mutex> lk(c->out_mu);
  while (!c->outbuf.empty()) {
    ssize_t n = send(c->fd, c->outbuf.data(), c->outbuf.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->outbuf.erase(0, (size_t)n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else if (n < 0 && errno == EINTR) {
      continue;
    } else {
      drop_conn(m, c);
      return;
    }
  }
  if (c->outbuf.empty() && c->want_epollout) {
    c->want_epollout = false;
    epoll_update(m, c);
  }
}

void accept_loop(Mux* m) {
  for (;;) {
    int fd = accept4(m->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) return;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto* c = new Conn();
    c->fd = fd;
    {
      std::lock_guard<std::mutex> lk(m->mu);
      c->id = m->next_id++;
      m->conns[c->id] = c;
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = c->id;
    epoll_ctl(m->epfd, EPOLL_CTL_ADD, fd, &ev);
    push_record(m, c->id, 1, "");
  }
}

void mux_thread(Mux* m) {
  epoll_event evs[128];
  for (;;) {
    int n = epoll_wait(m->epfd, evs, 128, -1);
    if (n < 0) {
      if (errno == EINTR) continue;
      return;
    }
    for (int i = 0; i < n; i++) {
      uint64_t id = evs[i].data.u64;
      if (id == 0) {  // wake_efd: stop or arm-EPOLLOUT requests
        uint64_t junk;
        ssize_t r = read(m->wake_efd, &junk, 8);
        (void)r;
        std::lock_guard<std::mutex> lk(m->mu);
        if (m->stopping) return;
        for (auto& [cid, c] : m->conns) {
          if (c->dead) continue;
          std::lock_guard<std::mutex> ck(c->out_mu);
          if (!c->outbuf.empty() && !c->want_epollout) {
            c->want_epollout = true;
            epoll_update(m, c);
          }
        }
        continue;
      }
      if (id == UINT64_MAX) {  // listen socket
        accept_loop(m);
        continue;
      }
      Conn* c;
      {
        std::lock_guard<std::mutex> lk(m->mu);
        auto it = m->conns.find(id);
        if (it == m->conns.end()) continue;
        c = it->second;
      }
      if (c->dead) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        handle_readable(m, c);  // drain anything delivered before the hup
        drop_conn(m, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) handle_writable(m, c);
      if (evs[i].events & EPOLLIN) handle_readable(m, c);
    }
  }
}

}  // namespace

extern "C" {

// returns handle or null; *out_port/*out_efd report the bound port and
// the eventfd Python should add_reader()
void* rt_mux_create(const char* host, uint16_t port, uint16_t* out_port,
                    int* out_efd) {
  auto* m = new Mux();
  m->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (m->listen_fd < 0) {
    delete m;
    return nullptr;
  }
  int one = 1;
  setsockopt(m->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  // inet_addr does NO hostname resolution: a name like "localhost" yields
  // INADDR_NONE, which as a bind address means 255.255.255.255 — reject
  // it here so the caller falls back (python resolves names first)
  in_addr_t ip = INADDR_ANY;
  if (host && host[0]) {
    ip = inet_addr(host);
    if (ip == INADDR_NONE) {
      close(m->listen_fd);
      delete m;
      return nullptr;
    }
  }
  addr.sin_addr.s_addr = ip;
  if (bind(m->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(m->listen_fd, 512) != 0) {
    close(m->listen_fd);
    delete m;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(m->listen_fd, (sockaddr*)&addr, &alen);
  m->port = ntohs(addr.sin_port);
  m->epfd = epoll_create1(0);
  m->ready_efd = eventfd(0, EFD_NONBLOCK);
  m->wake_efd = eventfd(0, EFD_NONBLOCK);
  if (m->epfd < 0 || m->ready_efd < 0 || m->wake_efd < 0) {
    // fd exhaustion etc.: fail the create instead of epoll_ctl'ing -1
    // handles and leaving the caller with a mux that can never signal
    if (m->epfd >= 0) close(m->epfd);
    if (m->ready_efd >= 0) close(m->ready_efd);
    if (m->wake_efd >= 0) close(m->wake_efd);
    close(m->listen_fd);
    delete m;
    return nullptr;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX;  // listen marker
  epoll_ctl(m->epfd, EPOLL_CTL_ADD, m->listen_fd, &ev);
  ev.events = EPOLLIN;
  ev.data.u64 = 0;  // wake marker
  epoll_ctl(m->epfd, EPOLL_CTL_ADD, m->wake_efd, &ev);
  m->thr = std::thread(mux_thread, m);
  *out_port = m->port;
  *out_efd = m->ready_efd;
  return m;
}

// Drain queued records into buf: [u64 conn_id][u32 type][u32 len][payload]*
// Returns bytes packed (0 = nothing); a NEGATIVE value is -(bytes needed)
// when the next record alone exceeds buflen (caller grows and retries).
// Stops before overflowing buf; the eventfd re-signals if records remain.
int64_t rt_mux_recv_batch(void* h, uint8_t* buf, uint64_t buflen) {
  auto* m = (Mux*)h;
  uint64_t junk;
  ssize_t r = read(m->ready_efd, &junk, 8);
  (void)r;
  size_t off = 0;
  bool more = false;
  {
    std::lock_guard<std::mutex> lk(m->mu);
    while (!m->inq.empty()) {
      Record& rec = m->inq.front();
      size_t need = 16 + rec.payload.size();
      if (off == 0 && need > buflen) {
        uint64_t one = 1;
        ssize_t w = write(m->ready_efd, &one, 8);
        (void)w;
        return -(int64_t)need;
      }
      if (off + need > buflen) {
        more = true;
        break;
      }
      memcpy(buf + off, &rec.conn_id, 8);
      memcpy(buf + off + 8, &rec.type, 4);
      uint32_t len = (uint32_t)rec.payload.size();
      memcpy(buf + off + 12, &len, 4);
      memcpy(buf + off + 16, rec.payload.data(), rec.payload.size());
      off += need;
      m->inq.pop_front();
    }
  }
  if (more) {
    uint64_t one = 1;
    ssize_t w = write(m->ready_efd, &one, 8);
    (void)w;
  }
  return (int64_t)off;
}

// Send a pre-framed message ([u64 len][payload] ALREADY included by the
// caller). Immediate non-blocking send when the out-buffer is empty; the
// rest spills to the buffer and the epoll thread finishes it.
int rt_mux_send(void* h, uint64_t conn_id, const char* data, uint64_t len) {
  auto* m = (Mux*)h;
  Conn* c;
  {
    std::lock_guard<std::mutex> lk(m->mu);
    auto it = m->conns.find(conn_id);
    if (it == m->conns.end()) return -1;
    c = it->second;
  }
  if (c->dead) return -1;
  bool need_wake = false;
  {
    std::lock_guard<std::mutex> ck(c->out_mu);
    if (c->outbuf.empty()) {
      uint64_t sent = 0;
      while (sent < len) {
        ssize_t n = send(c->fd, data + sent, len - sent, MSG_NOSIGNAL);
        if (n > 0) {
          sent += (uint64_t)n;
        } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          break;
        } else if (n < 0 && errno == EINTR) {
          continue;
        } else {
          return -1;  // epoll thread will observe the error and drop
        }
      }
      if (sent < len) {
        c->outbuf.assign(data + sent, len - sent);
        need_wake = true;
      }
    } else {
      if (c->outbuf.size() + len > kMaxOutBuf) return -2;  // backlogged
      c->outbuf.append(data, len);
      need_wake = !c->want_epollout;
    }
  }
  if (need_wake) {
    uint64_t one = 1;
    ssize_t w = write(m->wake_efd, &one, 8);
    (void)w;
  }
  return 0;
}

void rt_mux_close_conn(void* h, uint64_t conn_id) {
  auto* m = (Mux*)h;
  std::lock_guard<std::mutex> lk(m->mu);
  auto it = m->conns.find(conn_id);
  if (it != m->conns.end() && !it->second->dead) {
    // shutdown wakes the epoll thread with EPOLLHUP; it runs drop_conn
    shutdown(it->second->fd, SHUT_RDWR);
  }
}

// Python saw the disconnect record and dropped its wrapper: free the slot
void rt_mux_release(void* h, uint64_t conn_id) {
  auto* m = (Mux*)h;
  Conn* c = nullptr;
  {
    std::lock_guard<std::mutex> lk(m->mu);
    auto it = m->conns.find(conn_id);
    if (it == m->conns.end() || !it->second->dead) return;
    c = it->second;
    m->conns.erase(it);
  }
  close(c->fd);  // deferred from drop_conn (see fd-reuse note there)
  delete c;
}

uint16_t rt_mux_port(void* h) { return ((Mux*)h)->port; }

void rt_mux_stop(void* h) {
  auto* m = (Mux*)h;
  {
    std::lock_guard<std::mutex> lk(m->mu);
    m->stopping = true;
  }
  uint64_t one = 1;
  ssize_t w = write(m->wake_efd, &one, 8);
  (void)w;
  m->thr.join();
  close(m->listen_fd);
  {
    std::lock_guard<std::mutex> lk(m->mu);
    for (auto& [id, c] : m->conns) {
      close(c->fd);  // dead conns kept their fd open for the send race
      delete c;
    }
    m->conns.clear();
  }
  close(m->epfd);
  close(m->ready_efd);
  close(m->wake_efd);
  delete m;
}

}  // extern "C"
