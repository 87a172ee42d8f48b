// The KLVI and CHIVI values and gradients of a mean-field family on the
// eight-schools densities, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes (ops/mf_kernels.py, the launch plumbing both
// kernels share); the Python wrappers live in viabel_tpu_torch/ops/klvi_mf.py
// and ops/chivi_mf.py beside their plain versions, the autograd objectives
// of objectives.black_box_klvi and objectives.black_box_chivi.
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
// chivi_mf (a template over the type, the density and the family) is one
// evaluation of presampled CHIVI without the n_eff scaling
// (viabel_tpu/objectives.py:177-222) on the same families, densities,
// rows and runs.  With s = exp(log_scale) and the log-weights
//   lw_n     = log p(z_n) - log q(z_n),
// where along the path log q(z_n) = sum_j log t_df(t_nj) - sum_j
// log_scale_j for the t family and -sum_j t_nj^2 / 2 - d log(2 pi) / 2 -
// sum_j log_std_j for the Gaussian (its total derivative 0 in the mean and
// -1 in each log-scale):
//   log_norm  = max_n lw_n
//   w_n       = exp(lw_n - log_norm)^alpha
//   value     = log(sum_n w_n / n) / alpha + log_norm
//   grad_mean = alpha / n sum_n w_n g_n
//   grad_ls   = alpha / n (s sum_n w_n g_n t_n + sum_n w_n)
// written to value[k], grad[k] and log_norm[k].  Every weight needs the
// block's max first, so a thread keeps its draw's lw, g and t in registers
// between the two reductions (the max, then the 2 d + 1 weighted sums).
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
// What bounds them on an H100.  A KLVI launch reads some 4 KB (100 draws of
// 10 float32 values) and does some 10^4 operations, a CHIVI launch 20 KB
// (500 draws) and some 10^5: nanoseconds at the card's peaks.  What they
// wait for is latency, as the step's does: the counter, then the draws it
// names.  So every load that does not wait for the counter (the
// parameters, y and sigma) is issued beside it, one draw is a thread's
// (n_mc up to 256 for KLVI and 512 for CHIVI in one pass, more in a fixed
// stride), and the sums over the draws are warp shuffles in a fixed tree,
// then one barrier, after which thread c sums column c over the warps in
// warp order and writes its output: the order of every sum is fixed, so a
// run repeats to the bit.  CHIVI's max goes the same way before its sums;
// a thread past its first draw evaluates its further draws once for the
// max and again for the sums.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

constexpr int D = 2 + SCHOOLS;     // the eight-schools dimension
constexpr int P = 2 * D;           // [mean, log_scale]
// the sums over the draws: g, g t (d each) and log p; CHIVI's w g, w g t, w
constexpr int SUMS = 2 * D + 1;
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

// y and, as K1 makes them, 1 / sigma_j and sum_j log sigma_j (in order)
// into shared memory: threads 0 .. SCHOOLS - 1 of the block
template <typename T>
__device__ __forceinline__ void stage_schools(const ModelArgs<T>& model,
                                              int tid, T* s_y,
                                              ModelConsts<T>& consts) {
  if (tid >= SCHOOLS) return;
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

// each warp's sums of acc (column by column, a fixed tree over its lanes)
// into s_sums[warp], then the barrier; every thread of the block calls it
template <typename T>
__device__ __forceinline__ void block_sums(T (&acc)[SUMS], T (*s_sums)[SUMS],
                                           int lane, int warp) {
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
}

// column c of the block's sums: the warps' in warp order (after block_sums)
template <typename T>
__device__ __forceinline__ T column_total(T (*s_sums)[SUMS], int warps, int c) {
  T total = T(0);
  for (int w = 0; w < warps; ++w) total += s_sums[w][c];
  return total;
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
  stage_schools(model, tid, s_y, consts);
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
  block_sums(acc, s_sums, lane, warp);
  if (tid >= SUMS) return;
  const T total = column_total(s_sums, warps, tid);
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

// ---------------------------------------------------------------------------
// CHIVI

// a block's threads: a draw a thread up to here; float64 holds a draw's
// lw, g and t in registers without a spill only at 256 (the stride above)
constexpr int CHIVI_MAX_THREADS = 512;
constexpr int CHIVI_MAX_THREADS_F64 = 256;
constexpr int CHIVI_MAX_WARPS = CHIVI_MAX_THREADS / 32;

// The family's constants at one launch: 1 / df and (df + 1) / 2 of the t
// family, and the part of log q(z) that no draw moves: d t_lognorm(df)
// (the t family) or -d log(2 pi) / 2 (the Gaussian), less sum log_scale.
template <typename T>
struct BaseConsts {
  T inv_df, half_df1, log_q_shift;
};

// log p(z) - log q(z) at z = mean + scale t, and g = grad log p(z)
template <typename T, bool NCP, bool STUDENT_T>
__device__ __forceinline__ T chivi_draw(const T (&t)[D], const T* mean,
                                        const T* scale, const T* y,
                                        const ModelConsts<T>& k,
                                        const BaseConsts<T>& q, T (&g)[D]) {
  T x[D];
  T acc = T(0);  // sum log1p(t^2 / df) (t family) or sum t^2 (Gaussian)
#pragma unroll
  for (int j = 0; j < D; ++j) {
    x[j] = d_fma(scale[j], t[j], mean[j]);
    acc += STUDENT_T ? d_log1p(t[j] * t[j] * q.inv_df) : t[j] * t[j];
  }
  T log_q = (STUDENT_T ? -q.half_df1 * acc : T(-0.5) * acc) + q.log_q_shift;
  T lp = NCP ? ncp_value_grad<T>(x, y, k, g) : cp_value_grad<T>(x, y, k, g);
  return lp - log_q;
}

template <typename T>
__device__ __forceinline__ void load_draw(const T* row, int n, T (&t)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) t[j] = row[int64_t(n) * D + j];
}

template <typename T, bool NCP, bool STUDENT_T>
__global__ void __launch_bounds__(sizeof(T) == 8 ? CHIVI_MAX_THREADS_F64
                                                 : CHIVI_MAX_THREADS)
    chivi_mf_kernel(const T* __restrict__ param, const T* __restrict__ draws,
                    int64_t run_stride, const int64_t* __restrict__ counter,
                    int64_t n_iters, int n_mc, ModelArgs<T> model, T df,
                    T log_q_const, T alpha, T* __restrict__ value,
                    T* __restrict__ grad, T* __restrict__ log_norm) {
  __shared__ T s_mean[D], s_scale[D], s_y[SCHOOLS];
  __shared__ ModelConsts<T> consts;
  __shared__ BaseConsts<T> base;
  __shared__ T s_max[CHIVI_MAX_WARPS];
  __shared__ T s_sums[CHIVI_MAX_WARPS][SUMS];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;

  // the loads that do not wait for the counter, issued beside it
  const int64_t i = counter != nullptr ? counter[k] : 0;
  const T* p = param + int64_t(k) * P;
  if (tid < D) {  // sum_j log_scale_j summed in order
    T ls = p[D + tid];
    s_mean[tid] = p[tid];
    s_scale[tid] = d_exp(ls);
    T total = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) total += __shfl_sync((1u << D) - 1u, ls, j);
    if (tid == 0)
      base = BaseConsts<T>{T(1) / df, T(0.5) * (df + T(1)),
                           log_q_const - total};
  }
  stage_schools(model, tid, s_y, consts);
  const bool in_range = i >= 0 && i < n_iters;
  const T* row =
      draws + int64_t(k) * run_stride + (in_range ? i : 0) * int64_t(n_mc) * D;
  // this thread's first draw, loaded before the barrier and kept
  const bool mine = in_range && tid < n_mc;
  T t[D];
  if (mine) load_draw(row, tid, t);
  __syncthreads();

  // its log-weight and gradient, kept; the max over this thread's draws
  T g[D];
  T lw = T(-INFINITY);
  if (mine)
    lw = chivi_draw<T, NCP, STUDENT_T>(t, s_mean, s_scale, s_y, consts, base,
                                       g);
  T m = lw;
  for (int n = tid + blockDim.x; in_range && n < n_mc; n += blockDim.x) {
    T tn[D], gn[D];
    load_draw(row, n, tn);
    m = nan_max(m, chivi_draw<T, NCP, STUDENT_T>(tn, s_mean, s_scale, s_y,
                                                 consts, base, gn));
  }
  // the block's max (NaN propagates, as torch.max): lanes, then warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  T ln = s_max[0];
  for (int w = 1; w < warps; ++w) ln = nan_max(ln, s_max[w]);

  // the weighted sums over this thread's draws (tid, tid + blockDim.x, ...)
  T acc[SUMS];
#pragma unroll
  for (int c = 0; c < SUMS; ++c) acc[c] = T(0);
  if (mine) {
    T w = pow_alpha(lw - ln, alpha);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T wg = w * g[j];
      acc[j] = wg;
      acc[D + j] = wg * t[j];
    }
    acc[2 * D] = w;
  }
  for (int n = tid + blockDim.x; in_range && n < n_mc; n += blockDim.x) {
    T tn[D], gn[D];
    load_draw(row, n, tn);
    T w = pow_alpha(chivi_draw<T, NCP, STUDENT_T>(tn, s_mean, s_scale, s_y,
                                                  consts, base, gn) - ln,
                    alpha);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T wg = w * gn[j];
      acc[j] += wg;
      acc[D + j] = d_fma(wg, tn[j], acc[D + j]);
    }
    acc[2 * D] += w;
  }
  block_sums(acc, s_sums, lane, warp);
  if (tid >= SUMS) return;
  const T total = column_total(s_sums, warps, tid);
  const T nan = quiet_nan(T(0));
  const T n = T(n_mc);
  if (tid < D) {
    grad[int64_t(k) * P + tid] = in_range ? alpha * total / n : nan;
  } else if (tid < 2 * D) {
    // column 2 d, in the same order as its own thread's
    const T sum_w = column_total(s_sums, warps, 2 * D);
    grad[int64_t(k) * P + tid] =
        in_range ? alpha * d_fma(s_scale[tid - D], total, sum_w) / n : nan;
  } else {
    value[k] = in_range ? d_log(total / n) / alpha + ln : nan;
    log_norm[k] = in_range ? ln : nan;
  }
}

template <typename T>
int launch_chivi_mf(const void* param, const void* draws,
                    long long run_stride, const void* counter, int K,
                    long long n_iters, int n_mc, int d, const ModelSpec* spec,
                    int student_t, double df, double log_q_const,
                    double alpha, int threads, void* value, void* grad,
                    void* log_norm, void* stream) {
  if (K < 1 || n_iters < 1 || n_mc < 1 || d != D || run_stride < 0 ||
      spec == nullptr || spec->n_rows != SCHOOLS || threads < 32 ||
      threads > (sizeof(T) == 8 ? CHIVI_MAX_THREADS_F64 : CHIVI_MAX_THREADS) ||
      threads % 32 != 0 ||
      (student_t && !(df > 0)) || !(alpha > 0) ||
      (spec->kind != EIGHT_SCHOOLS_CP && spec->kind != EIGHT_SCHOOLS_NCP))
    return int(cudaErrorInvalidValue);
  const bool ncp = spec->kind == EIGHT_SCHOOLS_NCP;
  auto kernel = ncp ? (student_t ? chivi_mf_kernel<T, true, true>
                                 : chivi_mf_kernel<T, true, false>)
                    : (student_t ? chivi_mf_kernel<T, false, true>
                                 : chivi_mf_kernel<T, false, false>);
  kernel<<<K, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(param), static_cast<const T*>(draws),
      int64_t(run_stride), static_cast<const int64_t*>(counter),
      int64_t(n_iters), n_mc, ModelArgs<T>(*spec), T(df), T(log_q_const),
      T(alpha), static_cast<T*>(value), static_cast<T*>(grad),
      static_cast<T*>(log_norm));
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

int chivi_mf_f32(const void* param, const void* draws, long long run_stride,
                 const void* counter, int K, long long n_iters, int n_mc,
                 int d, const ModelSpec* spec, int student_t, double df,
                 double log_q_const, double alpha, int threads, void* value,
                 void* grad, void* log_norm, void* stream) {
  return launch_chivi_mf<float>(param, draws, run_stride, counter, K, n_iters,
                                n_mc, d, spec, student_t, df, log_q_const,
                                alpha, threads, value, grad, log_norm, stream);
}

int chivi_mf_f64(const void* param, const void* draws, long long run_stride,
                 const void* counter, int K, long long n_iters, int n_mc,
                 int d, const ModelSpec* spec, int student_t, double df,
                 double log_q_const, double alpha, int threads, void* value,
                 void* grad, void* log_norm, void* stream) {
  return launch_chivi_mf<double>(param, draws, run_stride, counter, K,
                                 n_iters, n_mc, d, spec, student_t, df,
                                 log_q_const, alpha, threads, value, grad,
                                 log_norm, stream);
}

}  // extern "C"
