// The KLVI value and gradient of a mean-field family on the eight-schools
// densities, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes; the Python wrapper lives in
// viabel_tpu_torch/ops/klvi_mf.py beside its plain version, the autograd
// objective of objectives.black_box_klvi.
//
// klvi_mf (a template over float and double, and over the centred and
// non-centred density) is one evaluation of presampled KLVI with the
// closed-form entropy (viabel_tpu/objectives.py:76-102) for the
// mean-field Student-t or Gaussian family, var_param = [mean (d),
// log_scale (d)], d = 10, on eight schools (J = 8), for each of K runs at
// once: block k serves run k.  Row i of run k's presampled (n_iters, n_mc,
// d) block of base draws t, with i read from run k's int64 counter on the
// device (the adagrad state's), so the same launch serves every iteration
// and replays from a CUDA graph beside the step kernel (without a counter
// it reads row 0; runs lie run_stride values apart, the rows of a run
// contiguous).  With z_n = mean + exp(log_scale) t_n, g_n the
// gradient of log p at z_n and H the entropy (sum log_scale for the t
// family, 0.5 d (1 + log 2 pi) + sum log_std for the Gaussian):
//   value          = -(H + mean_n log p(z_n))
//   grad_mean      = -mean_n g_n
//   grad_log_scale = -(1 + exp(log_scale) mean_n g_n t_n)
// written to value[k] and grad[k] for the step kernel to read.
//
// The gradient of the centred density at x = [mu, log_tau, theta], with
// tau = exp(log_tau), zt_j = (theta_j - mu) / tau, zy_j = (y_j - theta_j)
// / sigma_j and u = (tau / 5)^2:
//   d/dmu      = -mu / 25 + sum_j zt_j / tau
//   d/dlog_tau = 1 - 2 u / (1 + u) + sum_j zt_j^2 - J
//   d/dtheta_j = -zt_j / tau + zy_j / sigma_j
// and of the non-centred one at [mu, log_tau, tt], theta_j = mu + tau tt_j,
// r_j = (y_j - theta_j) / sigma_j^2:
//   d/dmu      = -mu / 25 + sum_j r_j
//   d/dlog_tau = 1 - 2 u / (1 + u) + tau sum_j r_j tt_j
//   d/dtt_j    = -tt_j + tau r_j
// (tests/test_torch_klvi_mf.py derives both in NumPy.)  The values are
// bound_pass.cuh's densities themselves, with the launch's 1 / sigma_j and
// summed log sigma_j made as K1 makes them.
//
// What bounds it on an H100.  A launch reads some 4 KB (100 draws of 10
// float32 values) and does some 10^4 operations: nanoseconds at the card's
// peaks.  What it waits for is latency, as the step's does: the counter,
// then the draws it names.  So every load that does not wait for the
// counter (the parameters, y and sigma) is issued beside it, one draw is a
// thread's (n_mc up to 256 in one pass, more in a fixed stride), and the
// 2 d + 1 sums over the draws are warp shuffles in a fixed tree, then one
// barrier, after which thread c sums column c over the warps in warp order
// and writes its output: the order of every sum is fixed, so a run repeats
// to the bit.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

constexpr int D = 2 + SCHOOLS;     // the eight-schools dimension
constexpr int P = 2 * D;           // [mean, log_scale]
constexpr int SUMS = 2 * D + 1;    // sum g (d), sum g t (d), sum log p
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SUMS <= 32, "one warp writes the outputs");

// a quiet NaN: the outputs of a counter past the block
__device__ __forceinline__ float quiet_nan(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// log p and its gradient at one sample of the centred density
template <typename T>
__device__ __forceinline__ T cp_value_grad(const T (&x)[D], const T* y,
                                           const ModelConsts<T>& k,
                                           T (&g)[D]) {
  T mu = x[0];
  T tau = d_exp(x[1]);
  T inv_tau = T(1) / tau;
  T ts = tau * T(0.2);
  T u = ts * ts;
  T sum_zt = T(0), s1 = T(0);
#pragma unroll
  for (int j = 0; j < SCHOOLS; ++j) {
    T zt = (x[2 + j] - mu) * inv_tau;
    sum_zt += zt;
    s1 = d_fma(zt, zt, s1);
    T zy = (y[j] - x[2 + j]) * k.inv_sigma[j];
    g[2 + j] = zy * k.inv_sigma[j] - zt * inv_tau;
  }
  g[0] = d_fma(sum_zt, inv_tau, -mu * T(0.04));
  g[1] = T(1) - T(2) * u / (T(1) + u) + (s1 - T(SCHOOLS));
  return eight_schools_cp<T, D>(x, y, k);
}

// log p and its gradient at one sample of the non-centred density
template <typename T>
__device__ __forceinline__ T ncp_value_grad(const T (&x)[D], const T* y,
                                            const ModelConsts<T>& k,
                                            T (&g)[D]) {
  T mu = x[0];
  T tau = d_exp(x[1]);
  T ts = tau * T(0.2);
  T u = ts * ts;
  T sum_r = T(0), sum_rt = T(0);
#pragma unroll
  for (int j = 0; j < SCHOOLS; ++j) {
    T tt = x[2 + j];
    T r = (y[j] - d_fma(tau, tt, mu)) * k.inv_sigma[j] * k.inv_sigma[j];
    sum_r += r;
    sum_rt = d_fma(r, tt, sum_rt);
    g[2 + j] = d_fma(tau, r, -tt);
  }
  g[0] = sum_r - mu * T(0.04);
  g[1] = T(1) - T(2) * u / (T(1) + u) + tau * sum_rt;
  return eight_schools_ncp<T, D>(x, y, k);
}

template <typename T, bool NCP>
__global__ void __launch_bounds__(MAX_THREADS)
    klvi_mf_kernel(const T* __restrict__ param, const T* __restrict__ draws,
                   int64_t run_stride, const int64_t* __restrict__ counter,
                   int64_t n_iters, int n_mc, ModelArgs<T> model,
                   T entropy_const,
                   T* __restrict__ value, T* __restrict__ grad) {
  __shared__ T s_mean[D], s_scale[D], s_log_scale[D], s_y[SCHOOLS];
  __shared__ ModelConsts<T> consts;
  __shared__ T s_sums[MAX_WARPS][SUMS];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;

  // the loads that do not wait for the counter, issued beside it
  const int64_t i = counter != nullptr ? counter[k] : 0;
  const T* p = param + int64_t(k) * P;
  if (tid < D) {
    T ls = p[D + tid];
    s_mean[tid] = p[tid];
    s_log_scale[tid] = ls;
    s_scale[tid] = d_exp(ls);
  }
  if (tid < SCHOOLS) {  // as K1: 1 / sigma_j, log sigma_j summed in order
    T sigma = model.b[tid];
    s_y[tid] = model.a[tid];
    consts.inv_sigma[tid] = T(1) / sigma;
    T log_sigma = d_log(sigma);
    T total = T(0);
#pragma unroll
    for (int j = 0; j < SCHOOLS; ++j)
      total += __shfl_sync((1u << SCHOOLS) - 1u, log_sigma, j);
    if (tid == 0) consts.sum_log_sigma = total;
  }
  const bool in_range = i >= 0 && i < n_iters;
  const T* row =
      draws + int64_t(k) * run_stride + (in_range ? i : 0) * int64_t(n_mc) * D;
  // this thread's first draw, loaded before the barrier
  T t[D];
  if (in_range && tid < n_mc) {
#pragma unroll
    for (int j = 0; j < D; ++j) t[j] = row[int64_t(tid) * D + j];
  }
  __syncthreads();

  // sums over this thread's draws (tid, tid + blockDim.x, ...), in order
  T acc[SUMS];
#pragma unroll
  for (int c = 0; c < SUMS; ++c) acc[c] = T(0);
  if (in_range) {
    for (int n = tid; n < n_mc; n += blockDim.x) {
      if (n != tid) {
#pragma unroll
        for (int j = 0; j < D; ++j) t[j] = row[int64_t(n) * D + j];
      }
      T x[D], g[D];
#pragma unroll
      for (int j = 0; j < D; ++j) x[j] = d_fma(s_scale[j], t[j], s_mean[j]);
      T lp = NCP ? ncp_value_grad<T>(x, s_y, consts, g)
                 : cp_value_grad<T>(x, s_y, consts, g);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        acc[j] += g[j];
        acc[D + j] = d_fma(g[j], t[j], acc[D + j]);
      }
      acc[2 * D] += lp;
    }
  }
  // a fixed tree over the warp's lanes, then the warps in order
#pragma unroll
  for (int c = 0; c < SUMS; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_down_sync(FULL, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < SUMS; ++c) s_sums[warp][c] = acc[c];
  }
  __syncthreads();
  if (tid >= SUMS) return;
  T total = T(0);
  for (int w = 0; w < warps; ++w) total += s_sums[w][tid];
  const T nan = quiet_nan(T(0));
  const T n = T(n_mc);
  if (tid < D) {
    grad[int64_t(k) * P + tid] = in_range ? -total / n : nan;
  } else if (tid < 2 * D) {
    int j = tid - D;
    grad[int64_t(k) * P + tid] =
        in_range ? -(T(1) + total / n * s_scale[j]) : nan;
  } else {
    T sum_ls = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) sum_ls += s_log_scale[j];
    value[k] = in_range ? -((entropy_const + sum_ls) + total / n) : nan;
  }
}

template <typename T>
int launch_klvi_mf(const void* param, const void* draws,
                   long long run_stride, const void* counter, int K,
                   long long n_iters, int n_mc, int d,
                   const ModelSpec* spec, double entropy_const, int threads,
                   void* value, void* grad, void* stream) {
  if (K < 1 || n_iters < 1 || n_mc < 1 || d != D || run_stride < 0 ||
      spec == nullptr ||
      spec->n_rows != SCHOOLS || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 ||
      (spec->kind != EIGHT_SCHOOLS_CP && spec->kind != EIGHT_SCHOOLS_NCP))
    return int(cudaErrorInvalidValue);
  auto kernel = spec->kind == EIGHT_SCHOOLS_NCP ? klvi_mf_kernel<T, true>
                                                : klvi_mf_kernel<T, false>;
  kernel<<<K, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(param), static_cast<const T*>(draws),
      int64_t(run_stride), static_cast<const int64_t*>(counter),
      int64_t(n_iters), n_mc,
      ModelArgs<T>(*spec), T(entropy_const), static_cast<T*>(value),
      static_cast<T*>(grad));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int klvi_mf_f32(const void* param, const void* draws, long long run_stride,
                const void* counter, int K, long long n_iters, int n_mc, int d,
                const ModelSpec* spec, double entropy_const, int threads,
                void* value, void* grad, void* stream) {
  return launch_klvi_mf<float>(param, draws, run_stride, counter, K, n_iters,
                               n_mc, d, spec, entropy_const, threads, value,
                               grad, stream);
}

int klvi_mf_f64(const void* param, const void* draws, long long run_stride,
                const void* counter, int K, long long n_iters, int n_mc, int d,
                const ModelSpec* spec, double entropy_const, int threads,
                void* value, void* grad, void* stream) {
  return launch_klvi_mf<double>(param, draws, run_stride, counter, K,
                                n_iters, n_mc, d, spec, entropy_const,
                                threads, value, grad, stream);
}

}  // extern "C"
