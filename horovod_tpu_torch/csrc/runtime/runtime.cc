// The negotiated runtime's state, its background loop and its C interface.
//
// The control half of the JAX package's horovod_tpu/runtime/cpp/runtime.cc
// (GlobalState, BackgroundThreadLoop, RunLoopOnce, the hvdrt_* entry
// points), under the port's names. The background thread runs the
// negotiation cycles (drain the queue into the pending table, announce,
// gather to rank 0, receive the fused ResponseList) without the GIL or any
// Python, so the star keeps cycling whatever the training thread does. It
// does not perform the responses: each cycle's list, with the handle of
// each local tensor, is queued for the port's Python executor
// (horovod_tpu_torch/runtime/__init__.py), which takes it with
// hvdtorch_rt_next (blocking with the GIL released) and performs the
// responses in broadcast order over NCCL or gloo.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "autotune.h"
#include "common.h"
#include "controller.h"
#include "logging.h"
#include "message.h"
#include "transport.h"

namespace hvdtorch {
namespace {

struct GlobalState {
  std::mutex mu;                   // guards queue, pending, join_requested
  std::deque<TensorEntry> queue;   // enqueued, not yet announced
  std::unordered_map<std::string, TensorEntry> pending;  // announced
  int32_t next_handle = 0;

  std::unique_ptr<Transport> transport;
  std::unique_ptr<Controller> controller;
  std::unique_ptr<ParameterManager> autotune;
  Config config;

  // Each cycle's serialized responses, for the executor (hvdtorch_rt_next).
  struct Frame {
    std::string data;
    int64_t bytes = 0;  // payload of its successful responses
    bool shutdown = false;
  };
  std::mutex frames_mu;
  std::condition_variable frames_cv;
  std::deque<Frame> frames;
  Frame current;  // the frame the executor holds (valid until its next call)
  bool loop_done = false;  // guarded by frames_mu
  std::thread background;

  // The ParameterManager runs on the executor's thread (it scores the time
  // the executor took per frame); the loop reads the knobs it sets.
  std::mutex knobs_mu;
  std::atomic<int64_t> fusion_threshold{0};
  std::atomic<double> cycle_time_ms{1.0};

  std::atomic<bool> shutdown_requested{false};
  std::atomic<bool> aborted{false};
  // JoinOp state: while joining, every cycle announces join and this rank
  // serves its peers' allreduces with zeros (the executor's part).
  std::atomic<bool> joining{false};
  std::atomic<int> join_result{-1};  // last rank to join, from kJoin
  std::atomic<bool> initialized{false};
  std::atomic<bool> dead{false};
  std::string fatal_error;  // set by the loop before the runtime dies

  int rank = -1, size = 0;
  std::atomic<int64_t> cycles{0};
};

// Atomic: readers may race a re-init's pointer swap. Superseded states are
// leaked on purpose, as the JAX package's runtime leaks its epochs: a
// caller may still hold the old pointer.
std::atomic<GlobalState*> g{nullptr};
std::mutex g_init_mu;
thread_local std::string tl_last_error;

void SetError(const std::string& e) { tl_last_error = e; }

double EnvDouble(const char* name, double dflt) {
  const char* v = std::getenv(name);
  if (v == nullptr || v[0] == '\0') return dflt;
  return std::atof(v);
}

int64_t EnvInt(const char* name, int64_t dflt) {
  const char* v = std::getenv(name);
  if (v == nullptr || v[0] == '\0') return dflt;
  return std::atoll(v);
}

bool CheckAlive(GlobalState* st) {
  if (st == nullptr || !st->initialized.load()) {
    SetError("not initialized");
    return false;
  }
  if (st->dead.load()) {
    SetError("runtime is dead: " + st->fatal_error);
    return false;
  }
  return true;
}

// Shared validation and entry construction (the JAX package's
// PrepareEntry). Returns false with the last error set.
bool PrepareEntry(GlobalState* st, const char* name, int op, int reduce_op,
                  int dtype, long long count, int root_rank, double prescale,
                  double postscale, int process_set_id, TensorEntry* out) {
  if (static_cast<OpType>(op) == OpType::kBroadcast &&
      (root_rank < 0 || root_rank >= st->size)) {
    SetError("broadcast root_rank " + std::to_string(root_rank) +
             " out of range for world size " + std::to_string(st->size));
    return false;
  }
  if (process_set_id != 0) {
    if (!st->controller->IsMember(process_set_id, st->rank)) {
      SetError("this rank (" + std::to_string(st->rank) + ") is not a "
               "member of process set " + std::to_string(process_set_id));
      return false;
    }
    if (static_cast<OpType>(op) == OpType::kBroadcast &&
        !st->controller->IsMember(process_set_id, root_rank)) {
      SetError("broadcast root_rank " + std::to_string(root_rank) +
               " is not a member of process set " +
               std::to_string(process_set_id));
      return false;
    }
  }
  TensorEntry e;
  e.name = name;
  e.op = static_cast<OpType>(op);
  e.reduce_op = static_cast<ReduceOp>(reduce_op);
  e.dtype = static_cast<DType>(dtype);
  e.count = count;
  e.root_rank = root_rank;
  e.prescale = prescale;
  e.postscale = postscale;
  e.process_set_id = process_set_id;
  e.enqueue_time_s = NowSeconds();
  *out = std::move(e);
  return true;
}

// Push entries under one lock acquisition (atomicity for groups). Fills
// `handles` in order; false on any name conflict (nothing enqueued).
bool PushEntries(GlobalState* st, std::vector<TensorEntry>* entries,
                 std::vector<int32_t>* handles) {
  std::lock_guard<std::mutex> lock(st->mu);
  for (size_t i = 0; i < entries->size(); ++i) {
    const auto& e = (*entries)[i];
    for (size_t j = 0; j < i; ++j) {
      if ((*entries)[j].name == e.name) {
        SetError("duplicate tensor name '" + e.name + "' within one "
                 "grouped enqueue");
        return false;
      }
    }
    if (st->pending.count(e.name) ||
        std::any_of(st->queue.begin(), st->queue.end(),
                    [&](const TensorEntry& q) { return q.name == e.name; })) {
      SetError("tensor '" + e.name + "' is already in flight (names must be "
               "unique per outstanding op, as in the reference)");
      return false;
    }
  }
  for (auto& e : *entries) {
    e.handle = st->next_handle++;
    handles->push_back(e.handle);
    st->queue.push_back(std::move(e));
  }
  return true;
}

// One negotiation cycle (the JAX package's RunLoopOnce without
// PerformOperation): fills *frame and sets *any when it holds a response.
// Returns false on a control-plane failure.
bool CycleOnce(GlobalState* st, GlobalState::Frame* frame, bool* any) {
  std::vector<Request> ready;
  {
    std::lock_guard<std::mutex> lock(st->mu);
    while (!st->queue.empty()) {
      TensorEntry e = std::move(st->queue.front());
      st->queue.pop_front();
      st->pending.emplace(e.name, std::move(e));
    }
    ready.reserve(st->pending.size());
    for (auto& [name, e] : st->pending) {
      Request r;
      r.name = name;
      r.op = e.op;
      r.reduce_op = e.reduce_op;
      r.dtype = e.dtype;
      r.count = e.count;
      r.root_rank = e.root_rank;
      r.prescale = e.prescale;
      r.postscale = e.postscale;
      r.process_set_id = e.process_set_id;
      r.group_key = e.group_key;
      r.group_size = e.group_size;
      ready.push_back(std::move(r));
    }
  }
  ResponseList responses;
  Status s = st->controller->ComputeResponseList(
      ready, st->shutdown_requested.load(), st->joining.load(), &responses);
  if (!s.ok) {
    st->fatal_error = "control plane failed: " + s.error;
    return false;
  }
  // The local handle of every tensor of every response, in order; -1 where
  // this rank has none (it joined, or is not a member of the set).
  std::vector<int32_t> handles;
  int64_t bytes = 0;
  {
    std::lock_guard<std::mutex> lock(st->mu);
    for (const auto& resp : responses.responses) {
      if (resp.op == OpType::kJoin) {
        st->join_result.store(resp.root_rank);
        st->joining.store(false);
        continue;
      }
      if (resp.error.empty()) {
        for (int64_t c : resp.counts) {
          bytes += c * static_cast<int64_t>(DTypeSize(resp.dtype));
        }
      }
      for (const auto& name : resp.tensor_names) {
        auto it = st->pending.find(name);
        if (it == st->pending.end()) {
          handles.push_back(-1);
        } else {
          handles.push_back(it->second.handle);
          st->pending.erase(it);
        }
      }
    }
  }
  frame->bytes = bytes;
  frame->shutdown = responses.shutdown;
  frame->data = SerializeResponseList(responses);
  frame->data.append(reinterpret_cast<const char*>(handles.data()),
                     handles.size() * sizeof(int32_t));
  *any = !responses.responses.empty();
  st->cycles.fetch_add(1);
  return true;
}

// The background loop (the JAX package's BackgroundThreadLoop): cycles
// back to back while tensors are in flight, every cycle time when idle;
// queues each cycle that carried a response, and the last one.
void BackgroundLoop(GlobalState* st) {
  while (true) {
    st->controller->set_fusion_threshold(st->fusion_threshold.load());
    GlobalState::Frame frame;
    bool any = false;
    if (st->aborted.load()) st->fatal_error = "runtime aborted";
    if (st->aborted.load() || !CycleOnce(st, &frame, &any)) {
      HVD_LOG(kError) << "negotiation loop exiting: " << st->fatal_error;
      st->dead.store(true);
      st->transport->Abort();
      std::lock_guard<std::mutex> lock(st->frames_mu);
      st->loop_done = true;
      st->frames_cv.notify_all();
      return;
    }
    bool shutdown = frame.shutdown;
    if (any || shutdown) {
      std::lock_guard<std::mutex> lock(st->frames_mu);
      st->frames.push_back(std::move(frame));
      if (shutdown) st->loop_done = true;
      st->frames_cv.notify_all();
    }
    if (shutdown) return;
    bool idle;
    {
      std::lock_guard<std::mutex> lock(st->mu);
      idle = st->queue.empty() && st->pending.empty() &&
             !st->joining.load() && !st->shutdown_requested.load();
    }
    if (idle) {
      std::this_thread::sleep_for(std::chrono::duration<double, std::milli>(
          st->cycle_time_ms.load()));
    }
  }
}

}  // namespace
}  // namespace hvdtorch

using namespace hvdtorch;

extern "C" {

// Form the control plane (the star). 0 on success, -1 on error
// (hvdtorch_rt_last_error() has the details).
int hvdtorch_rt_init(int rank, int size, const char* coord_addr,
                     int coord_port, double timeout_s) {
  std::lock_guard<std::mutex> lock(g_init_mu);
  GlobalState* prev = g.load();
  if (prev != nullptr && prev->initialized.load()) {
    SetError("already initialized");
    return -1;
  }
  auto* st = new GlobalState();
  st->rank = rank;
  st->size = size;
  st->config.fusion_threshold_bytes =
      EnvInt("HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024);
  st->config.cycle_time_ms = EnvDouble("HOROVOD_CYCLE_TIME", 1.0);
  st->config.cache_capacity =
      static_cast<int>(EnvInt("HOROVOD_CACHE_CAPACITY", 1024));
  st->config.stall_warning_s = EnvDouble("HOROVOD_STALL_CHECK_TIME", 60.0);
  st->config.stall_shutdown_s = EnvDouble("HOROVOD_STALL_SHUTDOWN_TIME", 0.0);
  Status s = Transport::Create(rank, size,
                               coord_addr ? coord_addr : "127.0.0.1",
                               coord_port, timeout_s, &st->transport);
  if (!s.ok) {
    SetError(s.error);
    delete st;
    return -1;
  }
  st->controller.reset(new Controller(st->transport.get(), st->config));
  st->fusion_threshold.store(st->config.fusion_threshold_bytes);
  st->cycle_time_ms.store(st->config.cycle_time_ms);
  if (EnvInt("HOROVOD_AUTOTUNE", 0) != 0) {
    const char* at_log = std::getenv("HOROVOD_AUTOTUNE_LOG");
    st->autotune.reset(new ParameterManager(
        st->config.fusion_threshold_bytes, st->config.cycle_time_ms,
        at_log ? at_log : ""));
  }
  st->initialized.store(true);
  g.store(st);
  st->background = std::thread([st] { BackgroundLoop(st); });
  return 0;
}

// The executor's next frame: blocks (with the GIL released: ctypes) until
// the loop queued one, for at most timeout_s. `last_exec_s` is the host time
// the executor took to perform the frame it held, scored with that frame's
// bytes by the ParameterManager (HOROVOD_AUTOTUNE=1), whose knobs the loop
// then runs with. On 0 or 1, *frame / *frame_len hold the ResponseList
// (message.cc's serialization) followed by one int32 handle per tensor of
// every non-join response, valid until the next call. Returns 0, 1 for the
// world's last frame (it shut down), 2 when no frame came within the
// timeout, or -1 when the control plane failed (the runtime is dead;
// hvdtorch_rt_last_error() names the failure).
int hvdtorch_rt_next(double last_exec_s, const char** frame,
                     long long* frame_len, double timeout_s) {
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) {
    SetError("not initialized");
    return -1;
  }
  if (st->autotune && st->current.bytes > 0) {
    std::lock_guard<std::mutex> lock(st->knobs_mu);
    if (st->autotune->Update(st->current.bytes, last_exec_s)) {
      st->fusion_threshold.store(st->autotune->fusion_threshold());
      st->cycle_time_ms.store(st->autotune->cycle_time_ms());
    }
  }
  st->current = GlobalState::Frame();
  std::unique_lock<std::mutex> lock(st->frames_mu);
  st->frames_cv.wait_for(
      lock, std::chrono::duration<double>(timeout_s), [st] {
        return !st->frames.empty() || st->dead.load() || st->loop_done;
      });
  if (st->dead.load()) {
    SetError(st->fatal_error);
    return -1;
  }
  if (st->frames.empty()) return 2;
  st->current = std::move(st->frames.front());
  st->frames.pop_front();
  *frame = st->current.data.data();
  *frame_len = static_cast<long long>(st->current.data.size());
  return st->current.shutdown ? 1 : 0;
}

// Ask the world to shut down: the next cycles announce it, and every
// rank's cycle returns 1 once rank 0 has seen it.
int hvdtorch_rt_request_shutdown() {
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) return 0;
  st->shutdown_requested.store(true);
  return 0;
}

// End a cycle blocked in the star (its sockets are shut down): the
// teardown's last resort when the loop did not stop.
int hvdtorch_rt_abort() {
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) return 0;
  st->aborted.store(true);
  st->transport->Abort();
  return 0;
}

// After the loop stopped (a shutdown, a failure or an abort): joins it; the
// runtime is no longer initialized, and a new hvdtorch_rt_init may form the
// next world.
int hvdtorch_rt_finalize() {
  std::lock_guard<std::mutex> lock(g_init_mu);
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) return 0;
  if (st->background.joinable()) st->background.join();
  st->transport->Abort();
  st->initialized.store(false);
  return 0;
}

// Whether the background loop has stopped (after a shutdown or a failure).
int hvdtorch_rt_loop_done() {
  GlobalState* st = g.load();
  if (st == nullptr) return 1;
  std::lock_guard<std::mutex> lock(st->frames_mu);
  return st->loop_done ? 1 : 0;
}

int hvdtorch_rt_is_alive() {
  GlobalState* st = g.load();
  return (st != nullptr && st->initialized.load() && !st->dead.load()) ? 1
                                                                       : 0;
}

// Enqueue one named collective; returns its handle (>= 0) or -1. count:
// the input's elements (allgather: this rank's; alltoall, reducescatter:
// the whole input).
int hvdtorch_rt_enqueue(const char* name, int op, int reduce_op, int dtype,
                        long long count, int root_rank, double prescale,
                        double postscale, int process_set_id) {
  GlobalState* st = g.load();
  if (!CheckAlive(st)) return -1;
  std::vector<TensorEntry> entries(1);
  if (!PrepareEntry(st, name, op, reduce_op, dtype, count, root_rank,
                    prescale, postscale, process_set_id, &entries[0])) {
    return -1;
  }
  std::vector<int32_t> handles;
  if (!PushEntries(st, &entries, &handles)) return -1;
  return handles[0];
}

// Atomic grouped enqueue (GroupTable role): the n tensors share one group
// key and are queued under one lock; the controller schedules the group
// all or nothing, never from the cache. 0 on success, -1 on error
// (nothing queued).
int hvdtorch_rt_enqueue_group(int n, const char** names, int op,
                              int reduce_op, int dtype,
                              const long long* counts, int process_set_id,
                              double prescale, double postscale,
                              int* handles_out) {
  GlobalState* st = g.load();
  if (!CheckAlive(st)) return -1;
  if (n <= 0) {
    SetError("empty group");
    return -1;
  }
  // Rank-identical group key: the names are identical across ranks by the
  // contract that makes negotiation work.
  std::string joined;
  for (int i = 0; i < n; ++i) {
    joined += names[i];
    joined += '\x1f';
  }
  std::string key = "g" + std::to_string(std::hash<std::string>{}(joined));
  std::vector<TensorEntry> entries(n);
  for (int i = 0; i < n; ++i) {
    if (!PrepareEntry(st, names[i], op, reduce_op, dtype, counts[i], 0,
                      prescale, postscale, process_set_id, &entries[i])) {
      return -1;
    }
    entries[i].group_key = key;
    entries[i].group_size = n;
  }
  std::vector<int32_t> handles;
  if (!PushEntries(st, &entries, &handles)) return -1;
  for (int i = 0; i < n; ++i) handles_out[i] = handles[i];
  return 0;
}

// Start this rank's join (JoinOp): its cycles announce join until every
// rank has joined; the cycle that carries the kJoin response clears it,
// and hvdtorch_rt_join_result() then holds the last rank to join. 1 if a
// join is already under way, 0 when one starts, -1 on error.
int hvdtorch_rt_join() {
  GlobalState* st = g.load();
  if (!CheckAlive(st)) return -1;
  std::lock_guard<std::mutex> lock(st->mu);
  if (st->joining.load()) return 1;
  if (!st->queue.empty() || !st->pending.empty()) {
    SetError("join requires all outstanding collectives to be "
             "synchronized first");
    return -1;
  }
  st->join_result.store(-1);
  st->joining.store(true);
  return 0;
}

int hvdtorch_rt_join_result() {
  GlobalState* st = g.load();
  return st ? st->join_result.load() : -1;
}

// Register a process set (every rank registers the same sets in the same
// order). Returns the set id (> 0), or -1.
int hvdtorch_rt_register_process_set(const int* ranks, int nranks) {
  GlobalState* st = g.load();
  if (!CheckAlive(st)) return -1;
  if (nranks <= 0) {
    SetError("process set must have at least one rank");
    return -1;
  }
  std::vector<int> v(ranks, ranks + nranks);
  for (int r : v) {
    if (r < 0 || r >= st->size) {
      SetError("process set rank " + std::to_string(r) +
               " out of range for world size " + std::to_string(st->size));
      return -1;
    }
  }
  return st->controller->RegisterProcessSet(std::move(v));
}

// Members of a set, ascending, into `out` (at most `cap`); their number,
// or -1 for an unknown set.
int hvdtorch_rt_process_set_members(int process_set_id, int* out, int cap) {
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) return -1;
  if (!st->controller->KnownProcessSet(process_set_id)) return -1;
  std::vector<int> m = st->controller->ProcessSetMembers(process_set_id);
  for (int i = 0; i < static_cast<int>(m.size()) && i < cap; ++i) {
    out[i] = m[i];
  }
  return static_cast<int>(m.size());
}

// The live knobs: 1 when HOROVOD_AUTOTUNE armed the ParameterManager, 0
// when not, -1 before init.
int hvdtorch_rt_autotune_state(long long* fusion_threshold,
                               double* cycle_time_ms, int* samples) {
  GlobalState* st = g.load();
  if (st == nullptr || !st->initialized.load()) return -1;
  std::lock_guard<std::mutex> lock(st->knobs_mu);
  *fusion_threshold = st->fusion_threshold.load();
  *cycle_time_ms = st->cycle_time_ms.load();
  *samples = st->autotune ? st->autotune->num_samples() : 0;
  return st->autotune ? 1 : 0;
}

long long hvdtorch_rt_cache_hits() {
  GlobalState* st = g.load();
  return st ? st->controller->cache().hits() : 0;
}

long long hvdtorch_rt_cache_misses() {
  GlobalState* st = g.load();
  return st ? st->controller->cache().misses() : 0;
}

long long hvdtorch_rt_cycles() {
  GlobalState* st = g.load();
  return st ? st->cycles.load() : 0;
}

const char* hvdtorch_rt_last_error() { return tl_last_error.c_str(); }

}  // extern "C"
