// Native compiled log-density provider: robust (Student-t) regression.
//
// Second model of the native backend (see eight_schools.cpp): the
// reference's robust-regression Stan program
// (reference: notebooks/robust-regression.ipynb cell 3 —
// beta ~ normal(0, prior_std); y ~ student_t(df, x*beta, noise_scale))
// as an ahead-of-time-compiled batched evaluator of the log posterior and
// its analytic gradient.  Rows are parameter vectors beta (dim D); data is
// the (N, D) design matrix and the (N,) response.

#include <cmath>
#include <cstdint>

namespace {
constexpr double kLog2Pi = 1.8378770664093453;  // log(2*pi)
}  // namespace

extern "C" {

// log p(beta | x, y) for n rows of dimension D.
// lognorm = log Gamma((df+1)/2) - log Gamma(df/2) - 0.5 log(df*pi)
// is passed in precomputed (no lgamma in the hot loop).
void robust_reg_log_prob(const double* beta, int64_t n, int64_t N,
                         int64_t D, const double* x, const double* y,
                         double df, double noise_scale, double prior_std,
                         double lognorm, double* out) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    const double* b = beta + i * D;
    double lp = 0.0;
    for (int64_t r = 0; r < N; ++r) {
      double mu = 0.0;
      const double* xr = x + r * D;
      for (int64_t d = 0; d < D; ++d) mu += xr[d] * b[d];
      const double res = (y[r] - mu) / noise_scale;
      lp += lognorm - 0.5 * (df + 1.0) * std::log1p(res * res / df)
            - std::log(noise_scale);
    }
    for (int64_t d = 0; d < D; ++d) {
      const double z = b[d] / prior_std;
      lp += -0.5 * (z * z + kLog2Pi) - std::log(prior_std);
    }
    out[i] = lp;
  }
}

// Analytic gradient d log p / d beta, same batching.
void robust_reg_grad_log_prob(const double* beta, int64_t n, int64_t N,
                              int64_t D, const double* x, const double* y,
                              double df, double noise_scale,
                              double prior_std, double* out) {
  const double ps2 = prior_std * prior_std;
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    const double* b = beta + i * D;
    double* g = out + i * D;
    for (int64_t d = 0; d < D; ++d) g[d] = -b[d] / ps2;
    for (int64_t r = 0; r < N; ++r) {
      double mu = 0.0;
      const double* xr = x + r * D;
      for (int64_t d = 0; d < D; ++d) mu += xr[d] * b[d];
      const double res = (y[r] - mu) / noise_scale;
      const double w = (df + 1.0) * res / ((df + res * res) * noise_scale);
      for (int64_t d = 0; d < D; ++d) g[d] += w * xr[d];
    }
  }
}

}  // extern "C"
