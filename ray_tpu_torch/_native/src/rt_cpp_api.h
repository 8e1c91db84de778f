// rt_cpp_api.h — the C++ worker API for ray_tpu_torch.
//
// The native-language task surface (ref equivalent: cpp/ `ray::Task(...)`,
// 9.2k LoC C++ worker API; here tasks are registered by name and invoked
// cross-language from any driver via ray_tpu_torch.cpp_function("name")).
//
// Usage — a worker binary:
//
//   #include "rt_cpp_api.h"
//   rt::ValuePtr Add(std::vector<rt::ValuePtr>& args) {
//     return rt::Value::integer(args.at(0)->i + args.at(1)->i);
//   }
//   RT_REMOTE(Add);
//   int main() { return rt::worker_main(); }
//
// Compile:  g++ -std=c++17 -O2 -I <this dir> my_worker.cc rt_cpp_worker.cc
// Point the cluster at the binary with RT_CPP_WORKER=<path>; then from
// Python:  ray_tpu_torch.cpp_function("Add").remote(2, 3)  ->  5.
#pragma once

#include <functional>
#include <map>
#include <string>
#include <vector>

#include "picklite.h"

namespace rt {

using picklite::Value;
using picklite::ValuePtr;

// A task: receives decoded args, returns the result value. Throw
// std::exception to fail the task (surfaces as TaskError on the driver).
using TaskFn = std::function<ValuePtr(std::vector<ValuePtr>&)>;

// Name -> function registry for this worker binary.
std::map<std::string, TaskFn>& task_registry();

inline void register_task(const std::string& name, TaskFn fn) {
  task_registry()[name] = std::move(fn);
}

struct TaskRegistrar {
  TaskRegistrar(const char* name, TaskFn fn) { register_task(name, std::move(fn)); }
};

// Registers `fn` under its own identifier as the task name.
#define RT_REMOTE(fn) static ::rt::TaskRegistrar rt_reg_##fn(#fn, fn)

// Run the worker execution loop: reads the RT_* env contract the raylet
// sets (RT_WORKER_ID, RT_RAYLET_HOST/PORT, ...), registers with the raylet,
// then serves push_task until the raylet connection drops.
int worker_main();

}  // namespace rt
