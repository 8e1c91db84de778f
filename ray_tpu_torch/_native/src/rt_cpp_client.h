// rt_cpp_client.h — C++ driver API for ray_tpu_torch.
//
// The native driver surface (ref equivalent: cpp/ `ray::Init()` +
// `ray::Task(...).Remote()`): a C++ program connects to a running cluster,
// leases C++ workers through the raylet, and submits tasks registered with
// RT_REMOTE in the cluster's C++ worker binary.
//
//   rt::Client c;
//   c.Connect("127.0.0.1", gcs_port);
//   auto v = c.Call("Add", {rt::Value::integer(2), rt::Value::integer(3)});
//   // v->i == 5
//   c.Close();
//
// Scope: blocking calls, inline results (<= max_inline_object_size), C++
// workers only. Ownership/borrowing of shm objects stays with Python
// drivers; this client is the task-submission surface.
#pragma once

#include <string>
#include <vector>

#include "rt_cpp_api.h"

namespace rt {

class Client {
 public:
  ~Client() { Close(); }

  // Resolve the raylet through the GCS and connect. False on failure.
  bool Connect(const std::string& gcs_host, int gcs_port);

  // Submit func_name(args...) to a C++ worker and wait for the result.
  // On task failure returns nullptr and fills *error (when given).
  ValuePtr Call(const std::string& func_name, std::vector<ValuePtr> args,
                std::string* error = nullptr);

  // Return the cached worker lease and drop connections.
  void Close();

  bool connected() const { return raylet_fd_ >= 0; }

 private:
  bool EnsureWorker(std::string* error);
  ValuePtr Rpc(int fd, const std::string& method, ValuePtr payload,
               std::string* error);

  int raylet_fd_ = -1;
  int worker_fd_ = -1;
  int64_t lease_id_ = -1;
  int64_t next_id_ = 1;
};

}  // namespace rt
