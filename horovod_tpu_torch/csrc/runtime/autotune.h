// Online autotuning of the negotiated runtime's knobs.
//
// A copy of the ParameterManager of the JAX package's
// horovod_tpu/runtime/cpp/autotune.{h,cc}: it scores (fusion_threshold,
// cycle_time) by the bytes each window of cycles performed over its
// seconds and steps the runtime's live knobs. Its Bayesian optimizer is the
// port's one copy of the GP and the optimizer (../bayes_opt.h), the one
// the Python autotuner loads too.
#pragma once

#include <cstdint>
#include <string>

#include "../bayes_opt.h"

namespace hvdtorch {

// Tunes (fusion_threshold_bytes, cycle_time_ms) online from observed
// throughput. Thread-compatible with the background loop (single caller).
class ParameterManager {
 public:
  ParameterManager(int64_t initial_threshold, double initial_cycle_ms,
                   const std::string& log_path);
  // Report one negotiation/execution window: bytes moved + wall seconds.
  // Returns true if the knobs changed (caller re-reads getters).
  bool Update(int64_t bytes, double seconds);
  int64_t fusion_threshold() const { return current_threshold_; }
  double cycle_time_ms() const { return current_cycle_ms_; }
  // After convergence (no improvement for `patience` suggestions) the
  // manager pins the best point and stops exploring.
  bool converged() const { return converged_; }
  int num_samples() const { return bo_.num_samples(); }

 private:
  void ApplyPoint(const std::vector<double>& p);
  void Log(double score);

  BayesianOptimizer bo_;
  int64_t current_threshold_;
  double current_cycle_ms_;
  std::string log_path_;
  // Sampling state: accumulate a window before scoring a point.
  int64_t window_bytes_ = 0;
  double window_seconds_ = 0.0;
  int windows_seen_ = 0;
  int warmup_windows_ = 3;   // discard initial windows (compile warmup)
  int window_per_sample_ = 5;
  bool converged_ = false;
  double last_best_ = -1e300;
  int no_improve_ = 0;
  int patience_ = 10;
};

}  // namespace hvdtorch
