// The autotuner's Bayesian optimizer: a Gaussian process (RBF kernel,
// Cholesky solve) with expected-improvement acquisition over random
// candidate draws from a std::mt19937_64 generator.
//
// Host code, built with g++ and loaded with ctypes by
// horovod_tpu_torch/autotune.py. A copy of the JAX package's native
// optimizer (horovod_tpu/runtime/cpp/autotune.{h,cc}: GaussianProcess,
// BayesianOptimizer) and of its C interface (runtime.cc, hvdrt_bo_*), under
// the port's names: the same arithmetic and the same generator, so that the
// same scores give the same suggestions bit for bit.

#include "bayes_opt.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <memory>
#include <mutex>
#include <random>
#include <unordered_map>
#include <vector>

namespace hvdtorch {

double GaussianProcess::Kernel(const std::vector<double>& a,
                               const std::vector<double>& b) const {
  double d2 = 0.0;
  for (size_t i = 0; i < a.size(); ++i) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return signal_var_ * std::exp(-d2 / (2.0 * length_scale_ * length_scale_));
}

void GaussianProcess::Fit(const std::vector<std::vector<double>>& x,
                          const std::vector<double>& y) {
  size_t n = x.size();
  x_ = x;
  y_mean_ = 0.0;
  for (double v : y) y_mean_ += v;
  y_mean_ /= static_cast<double>(n);
  double var = 0.0;
  for (double v : y) var += (v - y_mean_) * (v - y_mean_);
  y_std_ = std::sqrt(var / std::max<size_t>(1, n - 1));
  if (y_std_ < 1e-12) y_std_ = 1.0;

  // K + noise I, Cholesky factorization L L^T.
  std::vector<std::vector<double>> k(n, std::vector<double>(n));
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      k[i][j] = k[j][i] = Kernel(x[i], x[j]);
    }
    k[i][i] += noise_var_;
  }
  l_.assign(n, std::vector<double>(n, 0.0));
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      double sum = k[i][j];
      for (size_t p = 0; p < j; ++p) sum -= l_[i][p] * l_[j][p];
      if (i == j) {
        l_[i][i] = std::sqrt(std::max(sum, 1e-12));
      } else {
        l_[i][j] = sum / l_[j][j];
      }
    }
  }
  // alpha = K^-1 y' by two triangular solves.
  std::vector<double> z(n);
  for (size_t i = 0; i < n; ++i) {
    double sum = (y[i] - y_mean_) / y_std_;
    for (size_t p = 0; p < i; ++p) sum -= l_[i][p] * z[p];
    z[i] = sum / l_[i][i];
  }
  alpha_.assign(n, 0.0);
  for (size_t ii = n; ii-- > 0;) {
    double sum = z[ii];
    for (size_t p = ii + 1; p < n; ++p) sum -= l_[p][ii] * alpha_[p];
    alpha_[ii] = sum / l_[ii][ii];
  }
}

void GaussianProcess::Predict(const std::vector<double>& x, double* mu,
                              double* sigma) const {
  size_t n = x_.size();
  std::vector<double> kstar(n);
  for (size_t i = 0; i < n; ++i) kstar[i] = Kernel(x, x_[i]);
  double mean = 0.0;
  for (size_t i = 0; i < n; ++i) mean += kstar[i] * alpha_[i];
  // v = L^-1 k*; var = k(x,x) - v.v
  std::vector<double> v(n);
  for (size_t i = 0; i < n; ++i) {
    double sum = kstar[i];
    for (size_t p = 0; p < i; ++p) sum -= l_[i][p] * v[p];
    v[i] = sum / l_[i][i];
  }
  double var = Kernel(x, x) + noise_var_;
  for (size_t i = 0; i < n; ++i) var -= v[i] * v[i];
  *mu = mean * y_std_ + y_mean_;
  *sigma = std::sqrt(std::max(var, 1e-12)) * y_std_;
}

std::vector<double> BayesianOptimizer::Denormalize(
    const std::vector<double>& unit) const {
  std::vector<double> out(unit.size());
  for (size_t i = 0; i < unit.size(); ++i) {
    out[i] = lows_[i] + unit[i] * (highs_[i] - lows_[i]);
  }
  return out;
}

void BayesianOptimizer::AddSample(const std::vector<double>& params,
                                  double score) {
  std::vector<double> unit(params.size());
  for (size_t i = 0; i < params.size(); ++i) {
    double span = highs_[i] - lows_[i];
    unit[i] = span > 0 ? (params[i] - lows_[i]) / span : 0.0;
    unit[i] = std::clamp(unit[i], 0.0, 1.0);
  }
  x_.push_back(unit);
  y_.push_back(score);
  if (score > best_score_) {
    best_score_ = score;
    best_params_ = params;
  }
  gp_.Fit(x_, y_);
}

std::vector<double> BayesianOptimizer::Suggest() {
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  size_t d = lows_.size();
  if (static_cast<int>(y_.size()) < warmup_ || !gp_.fitted()) {
    std::vector<double> unit(d);
    for (auto& u : unit) u = uni(rng_);
    return Denormalize(unit);
  }
  double best = best_score_;
  double best_ei = -1.0;
  std::vector<double> best_unit(d, 0.5);
  for (int c = 0; c < 256; ++c) {
    std::vector<double> unit(d);
    for (auto& u : unit) u = uni(rng_);
    double mu, sigma;
    gp_.Predict(unit, &mu, &sigma);
    double z = (mu - best) / sigma;
    double cdf = 0.5 * std::erfc(-z / std::sqrt(2.0));
    double pdf = std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
    double ei = (mu - best) * cdf + sigma * pdf;
    if (ei > best_ei) {
      best_ei = ei;
      best_unit = unit;
    }
  }
  return Denormalize(best_unit);
}

}  // namespace hvdtorch

using hvdtorch::BayesianOptimizer;

static std::mutex bo_mu;
static std::unordered_map<int, std::unique_ptr<BayesianOptimizer>> bo_table;
static int bo_next_id = 1;

extern "C" {

int hvd_bo_new(int dims, const double* lows, const double* highs,
               long long seed) {
  std::lock_guard<std::mutex> lock(bo_mu);
  int id = bo_next_id++;
  bo_table[id].reset(new BayesianOptimizer(
      std::vector<double>(lows, lows + dims),
      std::vector<double>(highs, highs + dims),
      static_cast<uint64_t>(seed)));
  return id;
}

int hvd_bo_add(int id, const double* params, int dims, double score) {
  std::lock_guard<std::mutex> lock(bo_mu);
  auto it = bo_table.find(id);
  if (it == bo_table.end()) return -1;
  it->second->AddSample(std::vector<double>(params, params + dims), score);
  return 0;
}

int hvd_bo_suggest(int id, double* out, int dims) {
  std::lock_guard<std::mutex> lock(bo_mu);
  auto it = bo_table.find(id);
  if (it == bo_table.end()) return -1;
  std::vector<double> p = it->second->Suggest();
  if (static_cast<int>(p.size()) != dims) return -1;
  for (int i = 0; i < dims; ++i) out[i] = p[i];
  return 0;
}

double hvd_bo_best(int id, double* out, int dims) {
  std::lock_guard<std::mutex> lock(bo_mu);
  auto it = bo_table.find(id);
  if (it == bo_table.end()) return -1e300;
  const auto& p = it->second->best_params();
  if (out != nullptr && static_cast<int>(p.size()) == dims) {
    for (int i = 0; i < dims; ++i) out[i] = p[i];
  }
  return it->second->best_score();
}

int hvd_bo_free(int id) {
  std::lock_guard<std::mutex> lock(bo_mu);
  return bo_table.erase(id) ? 0 : -1;
}

}  // extern "C"
