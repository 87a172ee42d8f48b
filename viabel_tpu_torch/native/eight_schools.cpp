// Native compiled log-density provider: eight-schools centered model.
//
// Plays the role the compiled Stan C++ model plays in the reference
// (reference: viabel/vb.py:314-321 wraps pystan fit.log_prob /
// grad_log_prob) — a native, ahead-of-time-compiled evaluator of the
// unconstrained-space log posterior and its gradient, exposed over a C ABI
// and bridged into PyTorch via
// viabel_tpu_torch.models.make_callback_log_density (the port's copy of
// viabel_tpu/native/eight_schools.cpp).
// Unlike the reference's per-sample Python->C++ round trip
// (np.apply_along_axis; reference: viabel/vb.py:301-305), the entry points
// are batched: one call evaluates n parameter vectors.
//
// Unconstrained layout per row: [mu, log_tau, theta_1..theta_J]
// (matching viabel_tpu_torch/models/eight_schools.py).

#include <cmath>
#include <cstdint>

namespace {
constexpr double kLog2Pi = 1.8378770664093453;  // log(2*pi)
constexpr double kPi = 3.141592653589793;

inline double normal_lp(double x, double loc, double scale) {
  const double z = (x - loc) / scale;
  return -0.5 * (z * z + kLog2Pi) - std::log(scale);
}
}  // namespace

extern "C" {

// log p(z) for n rows of dimension dim = 2 + J.
void es_cp_log_prob(const double* z, int64_t n, int64_t J, const double* y,
                    const double* sigma, double* out) {
  const int64_t dim = 2 + J;
  for (int64_t i = 0; i < n; ++i) {
    const double* row = z + i * dim;
    const double mu = row[0];
    const double log_tau = row[1];
    const double tau = std::exp(log_tau);
    double lp = normal_lp(mu, 0.0, 5.0);
    // tau ~ cauchy(0, 5) on tau > 0, plus log-Jacobian of tau = exp(log_tau)
    lp += -std::log(kPi * 5.0 * (1.0 + (tau / 5.0) * (tau / 5.0))) + log_tau;
    for (int64_t j = 0; j < J; ++j) {
      const double theta = row[2 + j];
      lp += normal_lp(theta, mu, tau);
      lp += normal_lp(y[j], theta, sigma[j]);
    }
    out[i] = lp;
  }
}

// Analytic gradient d log p / d z, same batching.
void es_cp_grad_log_prob(const double* z, int64_t n, int64_t J,
                         const double* y, const double* sigma, double* out) {
  const int64_t dim = 2 + J;
  for (int64_t i = 0; i < n; ++i) {
    const double* row = z + i * dim;
    double* g = out + i * dim;
    const double mu = row[0];
    const double log_tau = row[1];
    const double tau = std::exp(log_tau);
    const double tau2 = tau * tau;
    double g_mu = -mu / 25.0;
    // d/dlog_tau of [cauchy(tau;0,5) + log_tau]
    double g_lt = 1.0 - 2.0 * tau2 / (25.0 + tau2);
    for (int64_t j = 0; j < J; ++j) {
      const double theta = row[2 + j];
      const double d = theta - mu;
      const double s2 = sigma[j] * sigma[j];
      g[2 + j] = -d / tau2 + (y[j] - theta) / s2;
      g_mu += d / tau2;
      g_lt += d * d / tau2 - 1.0;
    }
    g[0] = g_mu;
    g[1] = g_lt;
  }
}

}  // extern "C"
