// The Gaussian process and the Bayesian optimizer over it: declarations
// shared by the autotuner's library (bayes_opt.cc, its C interface
// hvd_bo_*) and the negotiated runtime's ParameterManager
// (runtime/autotune.cc), which is built from the same bayes_opt.cc: one
// copy of the GP.
#pragma once

#include <cstdint>
#include <random>
#include <vector>

namespace hvdtorch {

class GaussianProcess {
 public:
  // Fit on normalized inputs X in [0,1]^d with targets y (standardized
  // internally).
  void Fit(const std::vector<std::vector<double>>& x,
           const std::vector<double>& y);
  // Posterior mean and standard deviation at a point.
  void Predict(const std::vector<double>& x, double* mu, double* sigma) const;
  bool fitted() const { return !x_.empty(); }

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;
  std::vector<std::vector<double>> x_;
  std::vector<double> alpha_;           // K^-1 (y - mean)
  std::vector<std::vector<double>> l_;  // Cholesky factor of K + noise I
  double y_mean_ = 0.0, y_std_ = 1.0;
  double length_scale_ = 0.2, signal_var_ = 1.0, noise_var_ = 1e-4;
};

class BayesianOptimizer {
 public:
  BayesianOptimizer(std::vector<double> lows, std::vector<double> highs,
                    uint64_t seed)
      : lows_(std::move(lows)), highs_(std::move(highs)), rng_(seed) {}
  void AddSample(const std::vector<double>& params, double score);
  // The next point to try (denormalized): the first `warmup_` suggestions
  // are uniform draws, then argmax-EI over 256 random draws.
  std::vector<double> Suggest();
  const std::vector<double>& best_params() const { return best_params_; }
  double best_score() const { return best_score_; }
  int num_samples() const { return static_cast<int>(y_.size()); }

 private:
  std::vector<double> Denormalize(const std::vector<double>& unit) const;
  std::vector<double> lows_, highs_;
  std::vector<std::vector<double>> x_;  // normalized
  std::vector<double> y_;
  std::vector<double> best_params_;
  double best_score_ = -1e300;
  GaussianProcess gp_;
  std::mt19937_64 rng_;
  int warmup_ = 5;
};

}  // namespace hvdtorch
