// Core types of the negotiated runtime's control plane.
//
// A copy of the JAX package's horovod_tpu/runtime/cpp/common.h under the
// port's namespace: the op and reduce enums, the dtype codes, the config,
// the status and the staged tensor. The port adds the reductions and dtypes
// that torch.distributed reduces and the JAX package's host ring did not
// (kProduct; int8, int16, bool): the controller only compares them and
// sizes them for fusion. A staged tensor holds no data pointer: the
// caller's executor performs each response on its own tensors.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace hvdtorch {

enum class OpType : uint8_t {
  kAllreduce = 0,
  kAllgather = 1,
  kBroadcast = 2,
  kAlltoall = 3,
  kReducescatter = 4,
  kBarrier = 5,
  // Uneven-data termination (JoinOp). Emitted by the coordinator once
  // every rank has announced join; root_rank carries the last rank to join.
  kJoin = 6,
};

enum class ReduceOp : uint8_t {
  kSum = 0,
  kAverage = 1,
  kMin = 2,
  kMax = 3,
  kProduct = 4,
};

enum class DType : uint8_t {
  kFloat32 = 0,
  kFloat64 = 1,
  kInt32 = 2,
  kInt64 = 3,
  kUint8 = 4,
  kFloat16 = 5,
  kBFloat16 = 6,
  kInt8 = 7,
  kInt16 = 8,
  kBool = 9,
};

inline size_t DTypeSize(DType t) {
  switch (t) {
    case DType::kFloat32: return 4;
    case DType::kFloat64: return 8;
    case DType::kInt32: return 4;
    case DType::kInt64: return 8;
    case DType::kUint8: return 1;
    case DType::kFloat16: return 2;
    case DType::kBFloat16: return 2;
    case DType::kInt8: return 1;
    case DType::kInt16: return 2;
    case DType::kBool: return 1;
  }
  return 0;
}

struct Config {
  int64_t fusion_threshold_bytes = 64 * 1024 * 1024;
  double cycle_time_ms = 1.0;
  int cache_capacity = 1024;
  double stall_warning_s = 60.0;
  double stall_shutdown_s = 0.0;
};

struct Status {
  bool ok = true;
  std::string error;
  static Status OK() { return {}; }
  static Status Error(std::string msg) { return {false, std::move(msg)}; }
};

// A tensor enqueued by the framework layer, staged until the controller
// schedules it (reference role: TensorTableEntry).
struct TensorEntry {
  int32_t handle = -1;
  std::string name;
  OpType op;
  ReduceOp reduce_op = ReduceOp::kSum;
  DType dtype;
  int64_t count = 0;     // element count of the *input*
  int32_t root_rank = 0; // broadcast only
  double prescale = 1.0;
  double postscale = 1.0;
  double enqueue_time_s = 0.0;
  // Process set this op runs over (0 = world; ProcessSetTable role).
  int32_t process_set_id = 0;
  // Atomic group membership (GroupTable role): a non-empty key groups
  // tensors enqueued together; the controller only schedules the group
  // once ALL members are announced on all ranks.
  std::string group_key;
  int32_t group_size = 0;
};

double NowSeconds();

}  // namespace hvdtorch
