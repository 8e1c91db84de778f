// rt_cpp_worker.cc — C++ worker runtime for ray_tpu_torch.
//
// Speaks the control-plane wire protocol natively (length-prefixed pickle
// frames; codec in picklite.h) — the C++ peer of ray_tpu_torch/core/worker.py:
//   1. read the RT_* env contract the raylet's worker pool sets
//      (ref: worker_pool.h:231 fork/pop of language workers)
//   2. open a task-receiver server on an ephemeral port
//   3. register with the raylet: worker_ready{worker_id, address, pid}
//   4. serve push_task / cancel_if_current from driver connections
//   5. exit when the raylet connection closes (node death contract)
//
// Results are returned inline in the reply using the same packed layout as
// serialization.pack (u32 meta-len + pickled (sizes, header) + buffers);
// errors unpickle as real ray_tpu_torch.core.ref.TaskError on the driver.

#include <csignal>
#include <unistd.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <set>
#include <thread>

#include "rt_cpp_api.h"
#include "rt_wire.h"

namespace rt {

std::map<std::string, TaskFn>& task_registry() {
  static std::map<std::string, TaskFn> reg;
  return reg;
}

namespace {

using wire::dial;
using wire::pack_value;
using wire::read_frame;
using wire::unpack_value;
using wire::write_frame;

// ----------------------------------------------------------------- worker

// Shared per-connection state: the read loop and detached task threads
// both hold a reference; the fd closes only when the last user is done,
// so a late task reply can never hit a recycled descriptor.
struct ConnState {
  int fd;
  std::atomic<int> inflight{0};
  std::atomic<bool> eof{false};
  std::mutex close_mu;
  bool closed = false;

  explicit ConnState(int f) : fd(f) {}

  void maybe_close() {
    if (!eof.load() || inflight.load() != 0) return;
    std::lock_guard<std::mutex> g(close_mu);
    if (!closed) {
      closed = true;
      ::close(fd);
    }
  }
};

struct Worker {
  std::string worker_id_hex;
  std::string raylet_host;
  int raylet_port = 0;
  int server_fd = -1;
  int server_port = 0;
  std::atomic<long> current_task_lo{0};  // first 8 bytes of running task id
  std::mutex exec_mu;                    // one task at a time (worker invariant)
  std::mutex write_mu;                   // interleaved responses per process
  // tasks accepted but not yet finished, marked at push RECEIPT (reader
  // thread) — a force-cancel racing task startup or a pipelined task queued
  // behind exec_mu must still match (peer of worker.py _current_tasks)
  std::mutex pending_mu;
  std::set<long> pending_tasks;

  ValuePtr envelope(const char* kind, int64_t corr_id) {
    auto msg = Value::dict_();
    msg->set("k", Value::str(kind));
    if (corr_id >= 0) msg->set("i", Value::integer(corr_id));
    return msg;
  }

  bool respond(int fd, int64_t corr_id, ValuePtr value, ValuePtr error = nullptr) {
    auto msg = envelope("r", corr_id);
    msg->set("v", value ? value : Value::none());
    msg->set("e", error ? error : Value::none());
    std::string frame = picklite::dumps(*msg);
    std::lock_guard<std::mutex> g(write_mu);  // replies may interleave
    return write_frame(fd, frame);
  }

  ValuePtr run_task(const ValuePtr& spec, long tlo) {
    auto fname = spec->get("func_name");
    if (!fname || fname->kind != Value::kStr)
      throw std::runtime_error("spec has no func_name (cpp task expected)");
    auto it = task_registry().find(fname->s);
    if (it == task_registry().end())
      throw std::runtime_error("no C++ task registered as '" + fname->s + "'");
    std::vector<ValuePtr> args;
    auto spec_args = spec->get("args");
    if (spec_args) {
      for (auto& a : spec_args->items) {
        // arg descriptors from _resolve_args: ("v", packed) inline values;
        // ("r", id, owner) plasma refs are not supported in C++ tasks yet
        if (a->kind != Value::kTuple || a->items.empty())
          throw std::runtime_error("bad arg descriptor");
        const std::string& tag = a->items[0]->s;
        if (tag == "v") {
          args.push_back(unpack_value(a->items[1]->s));
        } else if (tag == "p") {
          args.push_back(a->items[1]);
        } else {
          throw std::runtime_error(
              "C++ tasks take inline args only (got ObjectRef arg)");
        }
      }
    }
    std::lock_guard<std::mutex> g(exec_mu);
    // mark under the execution lock: with pipelined pushes, the marker must
    // always name the task that is actually running
    current_task_lo.store(tlo);
    try {
      auto out = it->second(args);
      current_task_lo.store(0);
      return out;
    } catch (...) {
      current_task_lo.store(0);
      throw;
    }
  }

  void handle_push_task(int fd, int64_t corr_id, const ValuePtr& payload) {
    auto spec = payload->get("spec");
    ValuePtr reply = Value::dict_();
    try {
      if (!spec) throw std::runtime_error("no spec");
      // current-task marker for the cancel_if_current identity check
      auto tid = spec->get("task_id");
      long tlo = 0;
      if (tid && !tid->items.empty() && tid->items[0]->kind == Value::kBytes &&
          tid->items[0]->s.size() >= 8)
        std::memcpy(&tlo, tid->items[0]->s.data(), 8);
      ValuePtr value = run_task(spec, tlo);
      int64_t num_returns = 1;
      auto nr = spec->get("num_returns");
      if (nr && nr->kind == Value::kInt) num_returns = nr->i;
      auto results = Value::list();
      if (num_returns == 1) {
        auto r = Value::dict_();
        r->set("inline", Value::bytes(pack_value(value ? *value : Value())));
        results->items.push_back(r);
      } else if (num_returns > 1) {
        if (!value || value->kind != Value::kTuple ||
            (int64_t)value->items.size() != num_returns)
          throw std::runtime_error("task must return a tuple of num_returns items");
        for (auto& item : value->items) {
          auto r = Value::dict_();
          r->set("inline", Value::bytes(pack_value(*item)));
          results->items.push_back(r);
        }
      }
      reply->set("results", results);
    } catch (const std::exception& e) {
      auto err = Value::opaque("ray_tpu_torch.core.ref", "TaskError");
      err->items.push_back(Value::str(e.what()));
      reply->set("error", err);
    }
    respond(fd, corr_id, reply);
  }

  void serve_conn(std::shared_ptr<ConnState> cs) {
    const int fd = cs->fd;
    std::string frame;
    while (read_frame(fd, &frame)) {
      ValuePtr msg;
      try {
        msg = picklite::loads(frame);
      } catch (const std::exception&) {
        break;  // undecodable frame: drop the connection
      }
      auto kind = msg->get("k");
      if (!kind || kind->kind != Value::kStr) continue;
      if (kind->s == "n") continue;  // notifications: nothing to do yet
      if (kind->s != "c") continue;
      int64_t corr_id = msg->get("i") ? msg->get("i")->i : 0;
      auto method = msg->get("m");
      auto payload = msg->get("p");
      if (!method) continue;
      if (method->s == "push_task") {
        // mark at RECEIPT so a racing force-cancel can't slip between
        // accept and execution (the arg-decode window under exec_mu)
        long tlo = 0;
        auto spec = payload ? payload->get("spec") : nullptr;
        auto tid = spec ? spec->get("task_id") : nullptr;
        if (tid && !tid->items.empty() && tid->items[0]->kind == Value::kBytes &&
            tid->items[0]->s.size() >= 8)
          std::memcpy(&tlo, tid->items[0]->s.data(), 8);
        if (tlo != 0) {
          std::lock_guard<std::mutex> g(pending_mu);
          pending_tasks.insert(tlo);
        }
        // execute off-thread so this connection keeps reading — a
        // cancel_if_current sent on the SAME connection mid-task must be
        // seen while the task runs (exec_mu still serializes execution).
        // The ConnState ref keeps the fd alive until the reply is written.
        cs->inflight.fetch_add(1);
        std::thread([this, cs, corr_id, payload, tlo] {
          handle_push_task(cs->fd, corr_id, payload);
          if (tlo != 0) {
            std::lock_guard<std::mutex> g(pending_mu);
            pending_tasks.erase(tlo);
          }
          cs->inflight.fetch_sub(1);
          cs->maybe_close();
        }).detach();
      } else if (method->s == "cancel_if_current") {
        long tlo = 0;
        auto tid = payload ? payload->get("task_id") : nullptr;
        if (tid && !tid->items.empty() && tid->items[0]->s.size() >= 8)
          std::memcpy(&tlo, tid->items[0]->s.data(), 8);
        bool pending = false;
        if (tlo != 0) {
          std::lock_guard<std::mutex> g(pending_mu);
          pending = pending_tasks.count(tlo) != 0;
        }
        if (pending || (tlo != 0 && current_task_lo.load() == tlo)) {
          respond(fd, corr_id, Value::boolean(true));
          ::_exit(1);
        }
        respond(fd, corr_id, Value::boolean(false));
      } else if (method->s == "ping") {
        respond(fd, corr_id, Value::boolean(true));
      } else if (method->s == "__hello__") {
        auto v = Value::dict_();
        auto proto = Value::tuple();
        proto->items.push_back(Value::integer(wire::kProtocolMajor));
        proto->items.push_back(Value::integer(wire::kProtocolMinor));
        v->set("proto", proto);
        respond(fd, corr_id, v);
      } else {
        auto err = Value::opaque("ray_tpu_torch.utils.rpc", "RpcError");
        err->items.push_back(
            Value::str("cpp worker: no handler for '" + method->s + "'"));
        respond(fd, corr_id, nullptr, err);
      }
    }
    cs->eof.store(true);
    cs->maybe_close();
  }

  int run() {
    ::signal(SIGPIPE, SIG_IGN);  // peer-closed writes return EPIPE, not kill
    const char* wid = ::getenv("RT_WORKER_ID");
    const char* rh = ::getenv("RT_RAYLET_HOST");
    const char* rp = ::getenv("RT_RAYLET_PORT");
    if (!wid || !rh || !rp) {
      std::fprintf(stderr, "rt_cpp_worker: RT_WORKER_ID/RT_RAYLET_HOST/RT_RAYLET_PORT required\n");
      return 2;
    }
    worker_id_hex = wid;
    raylet_host = rh;
    raylet_port = std::atoi(rp);

    // task-receiver server on an ephemeral port; bind ANY so drivers on
    // other nodes can dial a leased C++ worker (loopback would wall it off)
    server_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = 0;
    if (::bind(server_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
        ::listen(server_fd, 64) != 0) {
      std::perror("rt_cpp_worker: bind/listen");
      return 2;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(server_fd, (sockaddr*)&addr, &alen);
    server_port = ntohs(addr.sin_port);

    // register with the raylet (same handshake as the python worker)
    int rfd = dial(raylet_host, raylet_port);
    if (rfd < 0) {
      std::fprintf(stderr, "rt_cpp_worker: cannot reach raylet %s:%d\n",
                   raylet_host.c_str(), raylet_port);
      return 2;
    }
    // advertise the address this host is reachable on: the local IP of the
    // raylet dial (RT_ADVERTISE_HOST overrides), not a hardcoded loopback —
    // a driver on another node must be able to dial this worker
    std::string adv_host = "127.0.0.1";
    if (const char* ah = std::getenv("RT_ADVERTISE_HOST")) {
      adv_host = ah;
    } else {
      sockaddr_in local{};
      socklen_t llen = sizeof(local);
      if (::getsockname(rfd, (sockaddr*)&local, &llen) == 0) {
        char buf[INET_ADDRSTRLEN];
        if (inet_ntop(AF_INET, &local.sin_addr, buf, sizeof(buf)))
          adv_host = buf;
      }
    }
    {
      auto msg = envelope("c", 1);
      msg->set("m", Value::str("worker_ready"));
      auto p = Value::dict_();
      p->set("worker_id", Value::str(worker_id_hex));
      auto address = Value::tuple();
      address->items.push_back(Value::str(adv_host));
      address->items.push_back(Value::integer(server_port));
      p->set("address", address);
      p->set("pid", Value::integer((int64_t)::getpid()));
      p->set("language", Value::str("cpp"));
      msg->set("p", p);
      if (!write_frame(rfd, picklite::dumps(*msg))) return 2;
      std::string ack;
      if (!read_frame(rfd, &ack)) return 2;  // {"k":"r","i":1,...}
    }

    // raylet link doubles as the liveness contract: EOF => node gone => exit
    std::thread([rfd] {
      std::string frame;
      while (read_frame(rfd, &frame)) {
        // raylet only pushes notifications at workers today; ignore them
      }
      ::_exit(0);
    }).detach();

    while (true) {
      int cfd = ::accept(server_fd, nullptr, nullptr);
      if (cfd < 0) continue;
      int one = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto cs = std::make_shared<ConnState>(cfd);
      std::thread([this, cs] { serve_conn(cs); }).detach();
    }
  }
};

}  // namespace

int worker_main() {
  Worker w;
  return w.run();
}

}  // namespace rt
