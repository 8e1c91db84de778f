// rt_cpp_client.cc — C++ driver implementation (see rt_cpp_client.h).
//
// Protocol: GCS get_cluster -> raylet lease_worker(language=cpp) ->
// worker push_task -> inline result; lease cached across Call()s and
// returned on Close() (ref: normal_task_submitter lease caching).

#include "rt_cpp_client.h"

#include <fcntl.h>
#include <unistd.h>

#include <cstring>
#include <random>

#include "rt_wire.h"

namespace rt {

using picklite::Value;
using wire::dial;
using wire::pack_value;
using wire::read_frame;
using wire::unpack_value;
using wire::write_frame;

namespace {

ValuePtr envelope(const char* kind, int64_t corr_id) {
  auto msg = Value::dict_();
  msg->set("k", Value::str(kind));
  msg->set("i", Value::integer(corr_id));
  return msg;
}

std::string random_bytes(size_t n) {
  std::string out(n, 0);
  static std::mt19937_64 rng{std::random_device{}()};
  for (size_t i = 0; i < n; ++i) out[i] = (char)(rng() & 0xff);
  return out;
}

}  // namespace

ValuePtr Client::Rpc(int fd, const std::string& method, ValuePtr payload,
                     std::string* error) {
  int64_t corr_id = next_id_++;
  auto msg = envelope("c", corr_id);
  msg->set("m", Value::str(method));
  msg->set("p", payload ? payload : Value::none());
  if (!write_frame(fd, picklite::dumps(*msg))) {
    if (error) *error = "send failed (" + method + ")";
    return nullptr;
  }
  // synchronous client: replies come back in order on this connection
  std::string frame;
  while (read_frame(fd, &frame)) {
    ValuePtr reply;
    try {
      reply = picklite::loads(frame);
    } catch (const std::exception& e) {
      if (error) *error = std::string("undecodable reply: ") + e.what();
      return nullptr;
    }
    auto kind = reply->get("k");
    if (!kind || kind->s != "r") continue;  // skip pushes/notifications
    auto i = reply->get("i");
    if (!i || i->i != corr_id) continue;    // not ours (stale)
    auto err = reply->get("e");
    if (err && err->kind != Value::kNone) {
      if (error) {
        *error = err->mod + "." + err->name;
        if (!err->items.empty() && err->items[0]->kind == Value::kStr)
          *error += ": " + err->items[0]->s;
      }
      return nullptr;
    }
    auto v = reply->get("v");
    return v ? v : Value::none();
  }
  if (error) *error = "connection lost (" + method + ")";
  return nullptr;
}

bool Client::Connect(const std::string& gcs_host, int gcs_port) {
  int gcs_fd = dial(gcs_host, gcs_port);
  if (gcs_fd < 0) return false;
  std::string err;
  auto cluster = Rpc(gcs_fd, "get_cluster", Value::dict_(), &err);
  ::close(gcs_fd);
  if (!cluster || cluster->kind != Value::kList || cluster->items.empty())
    return false;
  // the GCS view lists alive nodes, but liveness can lag reality (health
  // reaping interval): try each raylet in turn instead of failing on a
  // stale first entry
  for (auto& node : cluster->items) {
    auto alive = node->get("alive");
    if (alive && !alive->truthy()) continue;
    auto addr = node->get("address");
    if (!addr || addr->items.size() != 2) continue;
    raylet_fd_ = dial(addr->items[0]->s, (int)addr->items[1]->i);
    if (raylet_fd_ >= 0) return true;
  }
  return false;
}

bool Client::EnsureWorker(std::string* error) {
  if (worker_fd_ >= 0) return true;
  auto p = Value::dict_();
  auto res = Value::dict_();
  res->set("CPU", Value::real(1.0));
  p->set("resources", res);
  p->set("pg_id", Value::none());
  p->set("bundle_index", Value::integer(-1));
  p->set("language", Value::str("cpp"));
  // bind the lease to this (persistent) raylet connection: a crashed C++
  // driver must not leak its worker + resources (ref: lease disposal on
  // owner death)
  p->set("owner_bound", Value::boolean(true));
  auto grant = Rpc(raylet_fd_, "lease_worker", p, error);
  if (!grant) return false;
  auto granted = grant->get("granted");
  if (!granted || !granted->truthy()) {
    if (error) *error = "lease not granted (spillback not supported in C++ client)";
    return false;
  }
  auto waddr = grant->get("worker_address");
  auto lid = grant->get("lease_id");
  if (!waddr || waddr->items.size() != 2) {
    if (error) *error = "bad lease reply";
    return false;
  }
  lease_id_ = lid ? lid->i : -1;
  worker_fd_ = dial(waddr->items[0]->s, (int)waddr->items[1]->i);
  if (worker_fd_ < 0) {
    if (error) *error = "cannot reach leased worker";
    return false;
  }
  return true;
}

ValuePtr Client::Call(const std::string& func_name, std::vector<ValuePtr> args,
                      std::string* error) {
  if (raylet_fd_ < 0) {
    if (error) *error = "not connected";
    return nullptr;
  }
  if (!EnsureWorker(error)) return nullptr;

  auto spec = Value::dict_();
  auto tid = Value::opaque("ray_tpu_torch.utils.ids", "TaskID");
  tid->items.push_back(Value::bytes(random_bytes(16)));
  spec->set("task_id", tid);
  spec->set("name", Value::str(func_name));
  spec->set("func_name", Value::str(func_name));
  spec->set("func_id", Value::bytes("cpp:" + func_name));
  spec->set("language", Value::str("cpp"));
  auto arglist = Value::list();
  for (auto& a : args) {
    auto desc = Value::tuple();
    desc->items.push_back(Value::str("v"));
    desc->items.push_back(Value::bytes(pack_value(*a)));
    arglist->items.push_back(desc);
  }
  spec->set("args", arglist);
  spec->set("kwargs", Value::dict_());
  spec->set("num_returns", Value::integer(1));
  spec->set("owner_address", Value::none());
  spec->set("max_retries", Value::integer(0));
  spec->set("runtime_env", Value::none());

  auto payload = Value::dict_();
  payload->set("spec", spec);
  auto reply = Rpc(worker_fd_, "push_task", payload, error);
  if (!reply) {  // worker died mid-call: drop the lease, caller may retry
    ::close(worker_fd_);
    worker_fd_ = -1;
    lease_id_ = -1;
    return nullptr;
  }
  auto task_err = reply->get("error");
  if (task_err && task_err->kind != Value::kNone) {
    if (error) {
      *error = task_err->mod + "." + task_err->name;
      if (!task_err->items.empty() && task_err->items[0]->kind == Value::kStr)
        *error += ": " + task_err->items[0]->s;
    }
    return nullptr;
  }
  auto results = reply->get("results");
  if (!results || results->items.empty()) return Value::none();
  auto inline_b = results->items[0]->get("inline");
  if (!inline_b) {
    if (error) *error = "non-inline result (too large for the C++ client)";
    return nullptr;
  }
  try {
    return unpack_value(inline_b->s);
  } catch (const std::exception& e) {
    if (error) *error = std::string("result decode: ") + e.what();
    return nullptr;
  }
}

void Client::Close() {
  if (raylet_fd_ >= 0 && lease_id_ >= 0) {
    auto p = Value::dict_();
    p->set("lease_id", Value::integer(lease_id_));
    std::string err;
    Rpc(raylet_fd_, "return_lease", p, &err);
    lease_id_ = -1;
  }
  if (worker_fd_ >= 0) { ::close(worker_fd_); worker_fd_ = -1; }
  if (raylet_fd_ >= 0) { ::close(raylet_fd_); raylet_fd_ = -1; }
}

}  // namespace rt
