#include "controller.h"

#include <algorithm>
#include <sstream>

#include "logging.h"

namespace hvdtorch {

// -- ResponseCache -----------------------------------------------------------

int ResponseCache::Lookup(const Request& req) const {
  auto it = by_name_.find(req.name);
  if (it == by_name_.end()) return -1;
  // Signature change (same name, new shape/dtype/op) invalidates the hit.
  if (!entries_[it->second].SameSignature(req)) return -1;
  return it->second;
}

void ResponseCache::Touch(const Request& req) {
  auto it = by_name_.find(req.name);
  if (it != by_name_.end()) last_use_[it->second] = ++clock_;
}

void ResponseCache::Put(const Request& req) {
  if (capacity_ <= 0) return;  // cache disabled (HOROVOD_CACHE_CAPACITY=0)
  auto it = by_name_.find(req.name);
  if (it != by_name_.end()) {
    entries_[it->second] = req;  // re-keyed signature (e.g. re-used name)
    last_use_[it->second] = ++clock_;
    return;
  }
  int id;
  // Occupancy == by_name_.size(): every live slot has exactly one name.
  if (static_cast<int>(by_name_.size()) >= capacity_) {
    // Evict the least-recently-mirrored entry. Deterministic across
    // ranks: recency comes only from the identical broadcast stream.
    int victim = -1;
    uint64_t oldest = ~0ull;
    for (int i = 0; i < static_cast<int>(entries_.size()); ++i) {
      if (live_[i] && last_use_[i] < oldest) {
        oldest = last_use_[i];
        victim = i;
      }
    }
    by_name_.erase(entries_[victim].name);
    live_[victim] = false;
    id = victim;
  } else {
    // Prefer reusing a freed slot (keeps the bitvector narrow).
    id = -1;
    for (int i = 0; i < static_cast<int>(entries_.size()); ++i) {
      if (!live_[i]) {
        id = i;
        break;
      }
    }
    if (id < 0) {
      id = static_cast<int>(entries_.size());
      entries_.emplace_back();
      live_.push_back(false);
      last_use_.push_back(0);
    }
  }
  entries_[id] = req;
  live_[id] = true;
  last_use_[id] = ++clock_;
  by_name_[req.name] = id;
}

void ResponseCache::Clear() {
  entries_.clear();
  live_.clear();
  last_use_.clear();
  by_name_.clear();
  clock_ = 0;
}

// -- StallInspector ----------------------------------------------------------

void StallInspector::RecordPending(const std::string& name,
                                   const std::vector<int>& missing_ranks) {
  auto it = pending_.find(name);
  if (it == pending_.end()) {
    pending_[name] = Pending{NowSeconds(), missing_ranks, false};
  } else {
    it->second.missing = missing_ranks;
  }
}

void StallInspector::RecordResolved(const std::string& name) {
  pending_.erase(name);
}

std::string StallInspector::Check(bool* fatal) {
  *fatal = false;
  if (warning_s_ <= 0) return "";
  double now = NowSeconds();
  std::ostringstream report;
  for (auto& [name, p] : pending_) {
    double waited = now - p.first_seen_s;
    if (shutdown_s_ > 0 && waited > shutdown_s_) {
      *fatal = true;
    } else if (waited <= warning_s_ || p.warned) {
      continue;
    }
    p.warned = true;
    report << "tensor " << name << " submitted " << static_cast<int>(waited)
           << "s ago, still missing from rank(s) [";
    for (size_t i = 0; i < p.missing.size(); ++i) {
      if (i) report << ",";
      report << p.missing[i];
    }
    report << "]; ";
  }
  return report.str();
}

// -- Controller --------------------------------------------------------------

Controller::Controller(Transport* transport, const Config& config)
    : transport_(transport),
      config_(config),
      cache_(config.cache_capacity),
      stall_(config.stall_warning_s, config.stall_shutdown_s) {}

int Controller::RegisterProcessSet(std::vector<int> ranks) {
  std::sort(ranks.begin(), ranks.end());
  // Dedup BEFORE the identity check, or a duplicate-containing list never
  // matches its previously-registered deduped twin.
  ranks.erase(std::unique(ranks.begin(), ranks.end()), ranks.end());
  std::lock_guard<std::mutex> lock(ps_mu_);
  // Identical registration already present -> same id (idempotent, like
  // the reference's add_process_set of an existing set).
  for (size_t i = 0; i < process_sets_.size(); ++i) {
    if (process_sets_[i] == ranks) return static_cast<int>(i) + 1;
  }
  process_sets_.push_back(std::move(ranks));
  return static_cast<int>(process_sets_.size());
}

std::vector<int> Controller::ProcessSetMembers(int id) const {
  {
    std::lock_guard<std::mutex> lock(ps_mu_);
    if (id > 0 && id <= static_cast<int>(process_sets_.size())) {
      return process_sets_[id - 1];
    }
  }
  std::vector<int> world(transport_->size());
  for (int r = 0; r < transport_->size(); ++r) world[r] = r;
  return world;
}

bool Controller::KnownProcessSet(int id) const {
  if (id == 0) return true;
  std::lock_guard<std::mutex> lock(ps_mu_);
  return id > 0 && id <= static_cast<int>(process_sets_.size());
}

bool Controller::IsMember(int set_id, int rank) const {
  if (set_id <= 0) return true;
  std::lock_guard<std::mutex> lock(ps_mu_);
  if (set_id > static_cast<int>(process_sets_.size())) return false;
  const auto& m = process_sets_[set_id - 1];
  return std::binary_search(m.begin(), m.end(), rank);
}

Status Controller::ComputeResponseList(const std::vector<Request>& ready,
                                       bool request_shutdown, bool joining,
                                       ResponseList* out) {
  // Split announcements: cached signatures -> bitvector, rest -> requests.
  RequestList mine;
  mine.shutdown = request_shutdown;
  mine.joined = joining;
  int nbits = cache_.size();
  mine.cache_bits.assign((nbits + 63) / 64, 0);
  for (const auto& req : ready) {
    // Grouped tensors always take the slow path: the cache fast path has
    // no group gating, and atomic groups must schedule all-or-nothing.
    int id = req.group_key.empty() ? cache_.Lookup(req) : -1;
    if (id >= 0 && id < nbits) {
      mine.cache_bits[id / 64] |= (1ull << (id % 64));
      cache_.CountHit();
    } else {
      mine.requests.push_back(req);
      cache_.CountMiss();
    }
  }

  if (transport_->rank() == 0) {
    Status s = CoordinatorCycle(mine, out);
    if (!s.ok) return s;
  } else {
    Status s = transport_->GatherToRoot(SerializeRequestList(mine), nullptr);
    if (!s.ok) return s;
    std::string frame;
    s = transport_->BcastFromRoot(&frame);
    if (!s.ok) return s;
    s = ParseResponseList(frame, out);
    if (!s.ok) return s;
  }

  // Every rank mirrors the cache update from the broadcast responses, so
  // cache-id assignment stays rank-identical (ids follow response order).
  // Grouped responses are excluded (their tensors must renegotiate as a
  // group every time — see the announce phase above).
  for (const auto& resp : out->responses) {
    if (!resp.error.empty() || resp.grouped || resp.op == OpType::kBarrier ||
        resp.op == OpType::kJoin) {
      continue;
    }
    for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
      Request sig;
      sig.name = resp.tensor_names[i];
      sig.op = resp.op;
      sig.reduce_op = resp.reduce_op;
      sig.dtype = resp.dtype;
      sig.count = resp.counts[i];
      sig.root_rank = resp.root_rank;
      sig.prescale = resp.prescale;
      sig.postscale = resp.postscale;
      sig.process_set_id = resp.process_set_id;
      if (cache_.Lookup(sig) < 0) {
        cache_.Put(sig);  // may evict the LRU entry (rank-identical)
      } else {
        cache_.Touch(sig);  // refresh recency on reuse
      }
    }
  }
  return Status::OK();
}

Status Controller::CoordinatorCycle(const RequestList& mine,
                                    ResponseList* out) {
  std::vector<std::string> frames;
  Status s = transport_->GatherToRoot(SerializeRequestList(mine), &frames);
  if (!s.ok) return s;

  int size = transport_->size();
  std::vector<RequestList> lists(size);
  bool shutdown = false;
  for (int r = 0; r < size; ++r) {
    if (r == 0) {
      lists[0] = mine;
    } else {
      s = ParseRequestList(frames[r], &lists[r]);
      if (!s.ok) return s;
    }
    shutdown = shutdown || lists[r].shutdown;
  }

  // JoinOp bookkeeping: joined flags are sticky until every rank joins.
  if (static_cast<int>(joined_.size()) != size) joined_.assign(size, false);
  for (int r = 0; r < size; ++r) {
    if (lists[r].joined && !joined_[r]) {
      joined_[r] = true;
      last_joined_ = r;
    }
  }
  int joined_count = 0;
  for (int r = 0; r < size; ++r) joined_count += joined_[r] ? 1 : 0;

  std::vector<Response> responses;

  // 1. Cache fast path: a cached signature fires when every non-joined
  //    MEMBER of its process set announced the bit. (Joined ranks
  //    contribute zeros at execution, so their vote is implicit; non-member
  //    ranks never vote.) Per-id scan — set-aware agreement doesn't reduce
  //    to a word-wide AND, and nbits is small (<= cache capacity).
  auto has_bit = [&](int r, int id) -> bool {
    size_t w = static_cast<size_t>(id) / 64;
    return w < lists[r].cache_bits.size() &&
           ((lists[r].cache_bits[w] >> (id % 64)) & 1ull);
  };
  // Member lists resolved once per distinct set id per cycle — the cache
  // scan runs every background cycle and must not allocate per id.
  std::unordered_map<int32_t, std::vector<int>> members_by_set;
  auto members_of = [&](int32_t set_id) -> const std::vector<int>& {
    auto it = members_by_set.find(set_id);
    if (it == members_by_set.end()) {
      it = members_by_set.emplace(set_id, ProcessSetMembers(set_id)).first;
    }
    return it->second;
  };
  // A subset gather/broadcast whose member is joined cannot produce
  // correct data (the joined rank's zero scratch lands verbatim in the
  // output layout); subset allreduce composes fine — zeros plus the
  // contributing-rank divisor, same as the world path.
  auto joined_member_error = [&](const Request& req) -> std::string {
    if (joined_count == 0 || req.process_set_id == 0 ||
        req.op == OpType::kAllreduce || req.op == OpType::kBarrier) {
      return "";
    }
    for (int r : members_of(req.process_set_id)) {
      if (joined_[r]) {
        return "op on tensor '" + req.name + "' in process set " +
               std::to_string(req.process_set_id) + " has joined member "
               "rank " + std::to_string(r) + "; subset collectives do not "
               "compose with join()";
      }
    }
    return "";
  };
  // OR all ranks' bit words first: ids nobody announced are skipped
  // without touching the cache — idle cycles cost one word-OR pass, not a
  // per-id scan (word-wide fast path preserved from the pre-set design).
  size_t max_words = 0;
  for (int r = 0; r < size; ++r) {
    max_words = std::max(max_words, lists[r].cache_bits.size());
  }
  std::vector<uint64_t> any_bits(max_words, 0);
  for (int r = 0; r < size; ++r) {
    for (size_t w = 0; w < lists[r].cache_bits.size(); ++w) {
      any_bits[w] |= lists[r].cache_bits[w];
    }
  }
  int nbits_total = cache_.size();
  std::vector<int> missing;  // reused across ids: no per-id allocation
  for (int id = 0; id < nbits_total; ++id) {
    if (!((id / 64) < static_cast<int>(any_bits.size()) &&
          ((any_bits[id / 64] >> (id % 64)) & 1ull))) {
      continue;  // nobody announced this id: not in flight this cycle
    }
    if (!cache_.Valid(id)) continue;  // evicted slot
    const Request& sig = cache_.Get(id);
    const std::vector<int>& members = members_of(sig.process_set_id);
    int contributors = 0;
    missing.clear();
    for (int r : members) {
      if (joined_[r]) continue;
      if (has_bit(r, id)) {
        contributors++;
      } else {
        missing.push_back(r);
      }
    }
    if (contributors == 0) continue;
    if (!missing.empty()) {
      // Announced by some-but-not-all members: a stall in the making —
      // track it so steady-state hangs still get reported.
      stall_.RecordPending(sig.name, missing);
      continue;
    }
    stall_.RecordResolved(sig.name);
    Response resp;
    resp.op = sig.op;
    resp.reduce_op = sig.reduce_op;
    resp.dtype = sig.dtype;
    resp.root_rank = sig.root_rank;
    resp.prescale = sig.prescale;
    resp.postscale = sig.postscale;
    resp.tensor_names = {sig.name};
    resp.counts = {sig.count};
    resp.active_ranks = contributors;
    resp.process_set_id = sig.process_set_id;
    if (joined_count > 0 && sig.process_set_id == 0 &&
        sig.op != OpType::kAllreduce && sig.op != OpType::kBarrier) {
      resp.error = "op on tensor '" + sig.name +
                   "' is not supported while rank(s) are joined (only "
                   "allreduce/barrier compose with zero contributions)";
    }
    if (resp.error.empty()) resp.error = joined_member_error(sig);
    responses.push_back(std::move(resp));
  }
  // Cached-but-not-agreed bits stay pending on the ranks that set them; they
  // will be re-announced next cycle (the entry lives in the worker's queue).

  // 2. Slow path: full requests into the message table.
  for (int r = 0; r < size; ++r) {
    for (const auto& req : lists[r].requests) {
      auto [it, inserted] = message_table_.try_emplace(req.name);
      PendingTensor& pt = it->second;
      if (inserted) {
        pt.request = req;
        pt.announced.assign(size, false);
      } else if (!pt.request.SameSignature(req)) {
        Response err;
        err.op = req.op;
        err.dtype = req.dtype;
        err.tensor_names = {req.name};
        err.counts = {req.count};
        err.error = "mismatched signature for tensor '" + req.name +
                    "' across ranks (op/dtype/shape must agree)";
        responses.push_back(std::move(err));
        message_table_.erase(it);
        continue;
      }
      if (!pt.announced[r]) {
        pt.announced[r] = true;
        pt.announce_count++;
      }
    }
  }

  // 3. Promote tensors announced by every ACTIVE member of their process
  //    set (deterministic order: map iteration is name-sorted). Joined
  //    ranks participate in execution with zero contributions. Atomic
  //    groups (GroupTable role) promote all-or-nothing: a fully-announced
  //    member still waits until every tensor of its group is fully
  //    announced too.
  auto set_missing = [&](const PendingTensor& pt, std::vector<int>* missing) {
    for (int r : members_of(pt.request.process_set_id)) {
      if (!pt.announced[r] && !joined_[r]) missing->push_back(r);
    }
  };
  std::map<std::string, int> group_ready;  // group_key -> fully-announced
  for (auto& [name, pt] : message_table_) {
    if (pt.request.group_key.empty()) continue;
    std::vector<int> missing;
    set_missing(pt, &missing);
    if (missing.empty()) group_ready[pt.request.group_key]++;
  }
  for (auto it = message_table_.begin(); it != message_table_.end();) {
    PendingTensor& pt = it->second;
    std::vector<int> missing;
    set_missing(pt, &missing);
    bool group_ok = pt.request.group_key.empty() ||
                    group_ready[pt.request.group_key] >= pt.request.group_size;
    if (missing.empty() && group_ok) {
      const Request& req = pt.request;
      Response resp;
      resp.op = req.op;
      resp.reduce_op = req.reduce_op;
      resp.dtype = req.dtype;
      resp.root_rank = req.root_rank;
      resp.prescale = req.prescale;
      resp.postscale = req.postscale;
      resp.tensor_names = {req.name};
      resp.counts = {req.count};
      resp.active_ranks = pt.announce_count;
      resp.process_set_id = req.process_set_id;
      resp.grouped = !req.group_key.empty();
      if (joined_count > 0 && req.process_set_id == 0 &&
          req.op != OpType::kAllreduce && req.op != OpType::kBarrier) {
        resp.error = "op on tensor '" + req.name +
                     "' is not supported while rank(s) are joined (only "
                     "allreduce/barrier compose with zero contributions)";
      }
      if (req.process_set_id != 0 &&
          (req.op == OpType::kAlltoall || req.op == OpType::kReducescatter)) {
        // Subset alltoall/reducescatter ride the world ring with identity
        // contributions (like allreduce/allgather); the only structural
        // requirement is that the member count divides the tensor.
        const int64_t m = static_cast<int64_t>(
            members_of(req.process_set_id).size());
        if (m > 0 && req.count % m != 0) {
          resp.error = "op on tensor '" + req.name + "': count " +
                       std::to_string(req.count) + " does not divide by "
                       "process set size " + std::to_string(m);
        }
      }
      if (resp.error.empty()) resp.error = joined_member_error(req);
      responses.push_back(std::move(resp));
      stall_.RecordResolved(it->first);
      it = message_table_.erase(it);
    } else {
      if (!missing.empty()) stall_.RecordPending(it->first, missing);
      ++it;
    }
  }

  // 3b. Everyone joined: the join round completes. root_rank carries the
  //     last rank to join (reference: hvd.join()'s return value).
  if (joined_count == size) {
    Response done;
    done.op = OpType::kJoin;
    done.dtype = DType::kInt32;
    done.root_rank = last_joined_;
    responses.push_back(std::move(done));
    joined_.assign(size, false);
    last_joined_ = -1;
  }

  // 4. Stall check.
  bool fatal = false;
  std::string report = stall_.Check(&fatal);
  if (!report.empty()) {
    HVD_LOG(kWarning) << "stall detected: " << report
                      << "(ranks diverged? see HOROVOD_STALL_CHECK_TIME)";
  }
  if (fatal) {
    return Status::Error("stalled past HOROVOD_STALL_SHUTDOWN_TIME: " + report);
  }

  // 5. Fuse + broadcast.
  FuseResponses(&responses);
  out->responses = std::move(responses);
  out->shutdown = shutdown;
  std::string frame = SerializeResponseList(*out);
  return transport_->BcastFromRoot(&frame);
}

void Controller::FuseResponses(std::vector<Response>* responses) {
  // Pack same-(op, reduce_op, dtype, scale) single-tensor allreduce /
  // reducescatter responses into fused responses up to the threshold.
  // (Reference: Controller::FuseResponses; allgather/broadcast/alltoall are
  // not fused — layouts differ per tensor.)
  std::vector<Response> fused;
  std::vector<Response*> fusable;
  for (auto& r : *responses) {
    if (r.error.empty() &&
        (r.op == OpType::kAllreduce)) {
      fusable.push_back(&r);
    } else {
      fused.push_back(std::move(r));
    }
  }
  size_t i = 0;
  while (i < fusable.size()) {
    Response& base = *fusable[i];
    int64_t bytes = base.counts[0] * static_cast<int64_t>(DTypeSize(base.dtype));
    size_t j = i + 1;
    while (j < fusable.size()) {
      Response& cand = *fusable[j];
      int64_t cand_bytes =
          cand.counts[0] * static_cast<int64_t>(DTypeSize(cand.dtype));
      if (cand.op == base.op && cand.reduce_op == base.reduce_op &&
          cand.dtype == base.dtype && cand.prescale == base.prescale &&
          cand.postscale == base.postscale &&
          cand.active_ranks == base.active_ranks &&
          cand.process_set_id == base.process_set_id &&
          cand.grouped == base.grouped &&
          bytes + cand_bytes <= config_.fusion_threshold_bytes) {
        base.tensor_names.push_back(cand.tensor_names[0]);
        base.counts.push_back(cand.counts[0]);
        bytes += cand_bytes;
        fusable.erase(fusable.begin() + j);
      } else {
        ++j;
      }
    }
    fused.push_back(std::move(base));
    ++i;
  }
  *responses = std::move(fused);
}

}  // namespace hvdtorch
