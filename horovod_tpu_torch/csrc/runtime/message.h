// A copy of the JAX package's horovod_tpu/runtime/cpp/message.{h,cc} under
// the port's namespace: the same wire format.
//
// Control-plane wire messages.
//
// Reference role: horovod/common/message.{h,cc} (Request/Response +
// serialization). Original binary format: little-endian scalar writer, no
// external serializer dependency.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtorch {

// A worker announcing one ready tensor to the coordinator.
struct Request {
  std::string name;
  OpType op;
  ReduceOp reduce_op;
  DType dtype;
  int64_t count;
  int32_t root_rank;
  double prescale;
  double postscale;
  int32_t process_set_id = 0;  // 0 = world (ProcessSetTable role)
  std::string group_key;       // non-empty = atomic group (GroupTable role)
  int32_t group_size = 0;

  // Signature identity: two requests match iff all of these agree. The
  // coordinator validates cross-rank consistency (mismatch = user bug).
  // Group fields are deliberately excluded: grouping is scheduling intent,
  // not tensor identity.
  bool SameSignature(const Request& o) const {
    return name == o.name && op == o.op && reduce_op == o.reduce_op &&
           dtype == o.dtype && count == o.count && root_rank == o.root_rank &&
           prescale == o.prescale && postscale == o.postscale &&
           process_set_id == o.process_set_id;
  }
};

// One worker's per-cycle announcement: full requests for uncached tensors +
// a bitvector of ready tensors the response cache already knows.
struct RequestList {
  std::vector<Request> requests;
  std::vector<uint64_t> cache_bits;  // bit i = cached signature i is ready
  bool shutdown = false;
  bool joined = false;  // this rank exhausted its data (JoinOp)
};

// Coordinator's instruction: execute these tensors as one fused operation.
struct Response {
  OpType op;
  ReduceOp reduce_op;
  DType dtype;
  int32_t root_rank = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  std::vector<std::string> tensor_names;  // >1 = fused
  std::vector<int64_t> counts;            // per-tensor element counts
  std::string error;                      // non-empty = abort these tensors
  // Number of ranks that contributed data (0 = all): < world size while
  // some ranks are joined; Average divides by this, joined ranks
  // participate in the ring with zeros.
  int32_t active_ranks = 0;
  // Process set the collective runs over (0 = world). Non-member ranks
  // still execute the response — participating in the world ring with
  // identity-element contributions — but have no local entries.
  int32_t process_set_id = 0;
  // True when these tensors were enqueued as an atomic group: excluded
  // from the response cache so group scheduling stays all-or-nothing.
  bool grouped = false;
};

struct ResponseList {
  std::vector<Response> responses;
  bool shutdown = false;
};

// -- serialization ----------------------------------------------------------

std::string SerializeRequestList(const RequestList& list);
Status ParseRequestList(const std::string& data, RequestList* out);
std::string SerializeResponseList(const ResponseList& list);
Status ParseResponseList(const std::string& data, ResponseList* out);

}  // namespace hvdtorch
