#include "autotune.h"

#include <algorithm>
#include <cmath>
#include <cstdio>

#include "logging.h"

namespace hvdtorch {

// -- ParameterManager --------------------------------------------------------

ParameterManager::ParameterManager(int64_t initial_threshold,
                                   double initial_cycle_ms,
                                   const std::string& log_path)
    // Search space mirrors the reference's tunables: threshold 0..128 MiB
    // (log2-ish handled by the GP), cycle 0.5..50 ms.
    : bo_({0.0, 0.5}, {128.0 * 1024 * 1024, 50.0}, 42),
      current_threshold_(initial_threshold),
      current_cycle_ms_(initial_cycle_ms),
      log_path_(log_path) {}

void ParameterManager::ApplyPoint(const std::vector<double>& p) {
  current_threshold_ = std::max<int64_t>(1024, static_cast<int64_t>(p[0]));
  current_cycle_ms_ = std::max(0.1, p[1]);
}

void ParameterManager::Log(double score) {
  if (log_path_.empty()) return;
  FILE* f = std::fopen(log_path_.c_str(), "a");
  if (f == nullptr) return;
  std::fprintf(f, "%lld,%.3f,%.1f\n",
               static_cast<long long>(current_threshold_), current_cycle_ms_,
               score);
  std::fclose(f);
}

bool ParameterManager::Update(int64_t bytes, double seconds) {
  if (converged_) return false;
  windows_seen_++;
  if (windows_seen_ <= warmup_windows_) return false;  // discard warmup
  window_bytes_ += bytes;
  window_seconds_ += seconds;
  int windows_in_sample =
      windows_seen_ - warmup_windows_ -
      bo_.num_samples() * window_per_sample_;
  if (windows_in_sample < window_per_sample_) return false;

  double score = window_seconds_ > 0
                     ? static_cast<double>(window_bytes_) / window_seconds_
                     : 0.0;
  bo_.AddSample({static_cast<double>(current_threshold_), current_cycle_ms_},
                score);
  Log(score);
  window_bytes_ = 0;
  window_seconds_ = 0.0;

  if (bo_.best_score() > last_best_ * 1.02) {
    last_best_ = bo_.best_score();
    no_improve_ = 0;
  } else {
    no_improve_++;
  }
  if (no_improve_ >= patience_) {
    converged_ = true;
    ApplyPoint(bo_.best_params());
    HVD_LOG(kInfo) << "autotune converged: threshold="
                   << current_threshold_ << " cycle_ms=" << current_cycle_ms_
                   << " score=" << bo_.best_score();
    return true;
  }
  ApplyPoint(bo_.Suggest());
  return true;
}

}  // namespace hvdtorch
