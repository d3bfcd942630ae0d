// A copy of the JAX package's horovod_tpu/runtime/cpp/controller.{h,cc}
// under the port's namespace, whole: the same cache ids, LRU victims, fused
// groups, join bookkeeping and stall reports.
//
// Rank-0 coordinator: tensor-readiness negotiation, response cache with the
// bitvector fast path, response fusion, stall inspection.
//
// Reference roles: horovod/common/controller.{h,cc} (ComputeResponseList,
// FuseResponses, CoordinateCacheAndState), response_cache.{h,cc},
// stall_inspector.{h,cc}. Original implementation: the cache assigns stable
// ids to signatures; steady-state cycles exchange only ready-bitvectors,
// AND-ed at root — full request serialization happens only on cache misses.
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "message.h"
#include "transport.h"

namespace hvdtorch {

// Signature -> stable id cache, consistent across ranks because ids are
// assigned in Response broadcast order (every rank sees the same stream).
//
// Eviction (reference: response_cache.cc's LRU): recency is keyed on the
// MIRROR stream — Put/Touch run while applying the broadcast
// ResponseList, which is identical on every rank, so evictions pick the
// same victim everywhere without extra coordination. (Per-rank Lookup
// must NOT touch recency: announce order differs across ranks.) Evicted
// id slots are reused by later Puts; live ids never move.
class ResponseCache {
 public:
  explicit ResponseCache(int capacity) : capacity_(capacity) {}

  // Returns the cache id for a request's signature, or -1.
  int Lookup(const Request& req) const;
  // Record a negotiated single-tensor response (called on ALL ranks while
  // applying the broadcast ResponseList, keeping id assignment identical).
  // Evicts the least-recently-mirrored entry when at capacity.
  void Put(const Request& req);
  // Refresh recency for an existing signature (mirror stream only).
  void Touch(const Request& req);
  bool Valid(int cache_id) const {
    return cache_id >= 0 && cache_id < static_cast<int>(entries_.size()) &&
           live_[cache_id];
  }
  const Request& Get(int cache_id) const { return entries_[cache_id]; }
  int size() const { return static_cast<int>(entries_.size()); }
  int64_t hits() const { return hits_; }
  int64_t misses() const { return misses_; }
  void CountHit() { ++hits_; }
  void CountMiss() { ++misses_; }
  void Clear();

 private:
  int capacity_;
  std::vector<Request> entries_;  // id -> signature (slots reusable)
  std::vector<bool> live_;        // id -> occupied?
  std::vector<uint64_t> last_use_; // id -> mirror-stream clock at last use
  uint64_t clock_ = 0;
  std::unordered_map<std::string, int> by_name_;
  int64_t hits_ = 0, misses_ = 0;
};

// Tracks tensors announced by some-but-not-all ranks (coordinator only).
// Reference role: stall_inspector.cc.
class StallInspector {
 public:
  StallInspector(double warning_s, double shutdown_s)
      : warning_s_(warning_s), shutdown_s_(shutdown_s) {}

  void RecordPending(const std::string& name, const std::vector<int>& missing_ranks);
  void RecordResolved(const std::string& name);
  // Returns a non-empty report if some tensor stalled past the warning
  // threshold; sets *fatal if past the shutdown threshold.
  std::string Check(bool* fatal);

 private:
  struct Pending {
    double first_seen_s;
    std::vector<int> missing;
    bool warned = false;
  };
  double warning_s_, shutdown_s_;
  std::unordered_map<std::string, Pending> pending_;
};

class Controller {
 public:
  Controller(Transport* transport, const Config& config);

  // One negotiation cycle: announce `ready` tensors (+ cache bitvector),
  // receive the fused ResponseList every rank must execute in order.
  // On the coordinator this also runs bookkeeping + fusion + stall checks.
  Status ComputeResponseList(const std::vector<Request>& ready,
                             bool request_shutdown, bool joining,
                             ResponseList* out);

  ResponseCache& cache() { return cache_; }

  // Process-set table (reference: process_set.cc — ProcessSetTable).
  // Registration contract mirrors the reference: every rank registers the
  // same sets in the same order, so ids agree without extra coordination.
  // Returns the new set id. Set 0 is the world (implicit).
  int RegisterProcessSet(std::vector<int> ranks);
  // Members of a set (world when id is 0 or unknown).
  std::vector<int> ProcessSetMembers(int id) const;
  bool IsMember(int set_id, int rank) const;
  bool KnownProcessSet(int id) const;

  // Live autotune hook: the background loop re-points the fusion budget
  // when the ParameterManager steps (reference: ParameterManager feeding
  // Controller's fusion threshold).
  void set_fusion_threshold(int64_t bytes) {
    config_.fusion_threshold_bytes = bytes;
  }

 private:
  Status CoordinatorCycle(const RequestList& mine, ResponseList* out);
  void FuseResponses(std::vector<Response>* responses);

  Transport* transport_;
  Config config_;
  ResponseCache cache_;
  StallInspector stall_;
  // Coordinator: tensor name -> set of ranks that announced it + signature.
  struct PendingTensor {
    Request request;
    std::vector<bool> announced;
    int announce_count = 0;
  };
  std::map<std::string, PendingTensor> message_table_;  // ordered: determinism
  // JoinOp bookkeeping (coordinator): sticky per-rank joined flags for the
  // current join round; cleared when the kJoin response fires.
  std::vector<bool> joined_;
  int last_joined_ = -1;
  // id (minus 1) -> sorted member ranks; id 0 (world) is implicit.
  // Guarded: registration happens on API threads while the background
  // thread reads during negotiation/execution.
  mutable std::mutex ps_mu_;
  std::vector<std::vector<int>> process_sets_;
};

}  // namespace hvdtorch
