// Shared device code of the bound-pass kernels, for Hopper (sm_90a):
// the per-chunk statistics, the model log densities (eight-schools CP
// and NCP, the funnel, Bayesian regression), the Philox4x32-10 stream
// with Box-Muller, and the score kernel that K1 (lw_stats.cu, external
// draws) and K2 (gaussian_lw.cu, draws made in-kernel) both
// instantiate.  ops/_build.py hashes this header into every library
// built from csrc/, so an edit here rebuilds both.
//
// Partials layout, one row of NPART values per chunk of CHUNK consecutive
// samples (the last chunk may be ragged):
//   [count, m, mean_e, M2_e, mean_lw, M2_lw]
// with m the chunk max of lw, e = exp(lw - m)^alpha, mean/M2 the mean and
// sum of squared deviations.  Welford's update within a thread and Chan's
// rule across threads and chunks: the one-pass sum-of-squares form cancels
// in f32 and is never used.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bound_pass {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int NPART = 6;
constexpr int MAX_GRID = 4096;
constexpr int MAX_DIM = 32;  // the largest d a score kernel takes

constexpr double LOG_2PI = 1.8378770664093453;
constexpr double TWO_PI = 6.283185307179586;
constexpr double PI_5 = 15.707963267948966;  // pi * cauchy scale 5
constexpr double LOG_5 = 1.6094379124341003;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double d_fma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ void d_sincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void d_sincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// max that propagates NaN, as torch.max and jnp.max do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// exp(v)^alpha, the JAX package's form of the rescaled weight
template <typename T>
__device__ __forceinline__ T pow_alpha(T v, T alpha) {
  T e = d_exp(v);
  return alpha == T(2) ? e * e : d_pow(e, alpha);
}

template <typename T>
struct Moments {
  T count;  // exact: counts stay far below 2^24
  T mean_e, m2_e, mean_lw, m2_lw;
};

template <typename T>
__device__ __forceinline__ void welford(Moments<T>& s, T e, T lw) {
  s.count += T(1);
  T inv = T(1) / s.count;
  T de = e - s.mean_e;
  s.mean_e += de * inv;
  s.m2_e += de * (e - s.mean_e);
  T dl = lw - s.mean_lw;
  s.mean_lw += dl * inv;
  s.m2_lw += dl * (lw - s.mean_lw);
}

// Chan's rule: merge b into a; counts as double so that ratios stay exact
// for any n
template <typename T>
__device__ __forceinline__ void chan(double& na, T& mean_a, T& m2_a, double nb,
                                     T mean_b, T m2_b) {
  if (nb == 0.0) return;
  double n = na + nb;
  T delta = mean_b - mean_a;
  mean_a += delta * T(nb / n);
  m2_a += m2_b + delta * delta * T(na * nb / n);
  na = n;
}

template <typename T, int BS>
__device__ T block_max(T v, T* s_buf) {
  int tid = threadIdx.x;
  s_buf[tid] = v;
  __syncthreads();
  for (int s = BS / 2; s > 0; s >>= 1) {
    if (tid < s) s_buf[tid] = nan_max(s_buf[tid], s_buf[tid + s]);
    __syncthreads();
  }
  T out = s_buf[0];
  __syncthreads();
  return out;
}

// Tree of Chan merges in shared memory; thread 0 ends with the block's sums.
template <typename T, int BS>
__device__ void block_chan(double& n, T& me, T& m2e, T& ml, T& m2l,
                           double* s_n, T* s_me, T* s_m2e, T* s_ml, T* s_m2l) {
  int tid = threadIdx.x;
  s_n[tid] = n;
  s_me[tid] = me;
  s_m2e[tid] = m2e;
  s_ml[tid] = ml;
  s_m2l[tid] = m2l;
  __syncthreads();
  for (int s = BS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      double na = s_n[tid], nb = s_n[tid + s];
      T mea = s_me[tid], m2ea = s_m2e[tid];
      T mla = s_ml[tid], m2la = s_m2l[tid];
      double na2 = na;
      chan(na, mea, m2ea, nb, s_me[tid + s], s_m2e[tid + s]);
      chan(na2, mla, m2la, nb, s_ml[tid + s], s_m2l[tid + s]);
      s_n[tid] = na;
      s_me[tid] = mea;
      s_m2e[tid] = m2ea;
      s_ml[tid] = mla;
      s_m2l[tid] = m2la;
    }
    __syncthreads();
  }
  n = s_n[0];
  me = s_me[0];
  m2e = s_m2e[0];
  ml = s_ml[0];
  m2l = s_m2l[0];
  __syncthreads();
}

template <typename T>
struct SharedStats {
  T max_buf[THREADS];
  double n[THREADS];
  T me[THREADS], m2e[THREADS], ml[THREADS], m2l[THREADS];
};

// The chunk's partial row from the log-weights each thread holds in
// registers (v[k] valid where ok[k]).
template <typename T>
__device__ void chunk_partials(const T (&v)[ITEMS], const bool (&ok)[ITEMS],
                               T alpha, SharedStats<T>& sh, T* out_row) {
  T tmax = T(-INFINITY);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (ok[k]) tmax = nan_max(tmax, v[k]);
  T m = block_max<T, THREADS>(tmax, sh.max_buf);

  Moments<T> s = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (ok[k]) welford(s, pow_alpha(v[k] - m, alpha), v[k]);

  double n = double(s.count);
  block_chan<T, THREADS>(n, s.mean_e, s.m2_e, s.mean_lw, s.m2_lw, sh.n, sh.me,
                         sh.m2e, sh.ml, sh.m2l);
  if (threadIdx.x == 0) {
    out_row[0] = T(n);
    out_row[1] = m;
    out_row[2] = s.mean_e;
    out_row[3] = s.m2_e;
    out_row[4] = s.mean_lw;
    out_row[5] = s.m2_lw;
  }
}

// ---------------------------------------------------------------------------
// Model log densities.  The model's data sits in shared memory (staged by
// the score kernel); the sample in registers.
// ---------------------------------------------------------------------------

enum ModelKind {
  EIGHT_SCHOOLS_CP = 0,
  REGRESSION = 1,
  EIGHT_SCHOOLS_NCP = 2,
  FUNNEL = 3
};

// What the host passes for a model, by pointer, through the C interface;
// ops/lw_stats.py mirrors it as a ctypes Structure.  a and b point to
// device arrays in the launch's dtype: eight-schools CP and NCP a = y,
// b = sigma (n_rows = J = 8); regression a = x (n_rows, d) row-major,
// b = y.  The funnel stages no data (n_rows = 0, a = b = null) and reads
// its log_sigma prior's scale s from prior_std and log(s) from log_prior.
struct ModelSpec {
  int kind;
  int n_rows;
  int student_t;  // regression likelihood: 1 Student-t(df), 0 Gaussian
  int pad;
  const void* a;
  const void* b;
  double df, half_df1, lik_lognorm;  // t: df, (df + 1) / 2, log-normalizer
  double noise_scale, log_noise;
  double prior_std, log_prior;  // regression: N(0, prior_std) on beta;
                                // funnel: N(0, s) on log_sigma
};

template <typename T>
struct ModelArgs {
  int kind, n_rows, student_t;
  const T* a;
  const T* b;
  T df, half_df1, lik_lognorm, noise_scale, log_noise, prior_std, log_prior;

  __host__ explicit ModelArgs(const ModelSpec& m)
      : kind(m.kind), n_rows(m.n_rows), student_t(m.student_t),
        a(static_cast<const T*>(m.a)), b(static_cast<const T*>(m.b)),
        df(T(m.df)), half_df1(T(m.half_df1)), lik_lognorm(T(m.lik_lognorm)),
        noise_scale(T(m.noise_scale)), log_noise(T(m.log_noise)),
        prior_std(T(m.prior_std)), log_prior(T(m.log_prior)) {}

  // values of a and b, staged into shared memory
  __host__ __device__ int n_a(int d) const {
    return kind == FUNNEL ? 0 : kind == REGRESSION ? n_rows * d : n_rows;
  }
  __host__ __device__ int n_b() const { return kind == FUNNEL ? 0 : n_rows; }
};

// Centred eight-schools at one sample, in the order of
// viabel_tpu/models/eight_schools.py:70-78 (d = 10, J = 8).
template <typename T, int MAXD>
__device__ __forceinline__ T eight_schools_cp(const T (&x)[MAXD],
                                              const T* y, const T* sigma) {
  static_assert(MAXD >= 10, "eight-schools CP needs d = 10");
  constexpr int J = 8;
  const T log_2pi = T(LOG_2PI);
  T mu = x[0], log_tau = x[1];
  T tau = d_exp(log_tau);
  T zmu = mu / T(5);
  T lp = T(-0.5) * (zmu * zmu + log_2pi) - T(LOG_5);
  T ts = tau / T(5);
  lp += -d_log(T(PI_5) * (T(1) + ts * ts)) + log_tau;
  T log_scale_tau = d_log(tau);  // log(exp(log_tau)), as the JAX density
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T zt = (x[2 + j] - mu) / tau;
    s1 += T(-0.5) * (zt * zt + log_2pi) - log_scale_tau;
  }
  lp += s1;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T zy = (y[j] - x[2 + j]) / sigma[j];
    s2 += T(-0.5) * (zy * zy + log_2pi) - d_log(sigma[j]);
  }
  return lp + s2;
}

// Bayesian regression at one coefficient vector beta (d values), in the
// order of viabel_tpu/ops/row_models.py:55-68 at 2e6dc2c^ and
// viabel_tpu_torch/models/regression.py: mu_k = sum_j x_kj beta_j in plain
// FMA loops (no tensor cores, so no TF32), then a Gaussian or Student-t
// likelihood of scale noise_scale and an N(0, prior_std) prior.  x and y
// are in shared memory; every thread of a warp reads the same row, which
// the hardware broadcasts.
template <typename T, int MAXD>
__device__ __forceinline__ T regression(const T (&beta)[MAXD], int d,
                                        const T* x, const T* y,
                                        const ModelArgs<T>& m) {
  const T log_2pi = T(LOG_2PI);
  T loglik = T(0);
  for (int k = 0; k < m.n_rows; ++k) {
    const T* xk = x + k * d;
    T mu = T(0);
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) mu = d_fma(xk[j], beta[j], mu);
    T z = (y[k] - mu) / m.noise_scale;
    if (m.student_t)
      loglik += m.lik_lognorm - m.half_df1 * d_log1p(z * z / m.df) -
                m.log_noise;
    else
      loglik += T(-0.5) * (z * z + log_2pi) - m.log_noise;
  }
  T logprior = T(0);
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) {
      T zb = beta[j] / m.prior_std;
      logprior += T(-0.5) * (zb * zb + log_2pi) - m.log_prior;
    }
  }
  return loglik + logprior;
}

// Non-centred eight-schools at one sample, in the order of
// viabel_tpu/models/eight_schools.py:99-108 (d = 10, J = 8):
// theta = mu + tau * tt, an N(0, 1) prior on tt, and y ~ N(theta, sigma).
template <typename T, int MAXD>
__device__ __forceinline__ T eight_schools_ncp(const T (&x)[MAXD],
                                               const T* y, const T* sigma) {
  static_assert(MAXD >= 10, "eight-schools NCP needs d = 10");
  constexpr int J = 8;
  const T log_2pi = T(LOG_2PI);
  T mu = x[0], log_tau = x[1];
  T tau = d_exp(log_tau);
  T zmu = mu / T(5);
  T lp = T(-0.5) * (zmu * zmu + log_2pi) - T(LOG_5);
  T ts = tau / T(5);
  lp += -d_log(T(PI_5) * (T(1) + ts * ts)) + log_tau;
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T tt = x[2 + j];
    s1 += T(-0.5) * (tt * tt + log_2pi);
  }
  lp += s1;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T theta = mu + tau * x[2 + j];
    T zy = (y[j] - theta) / sigma[j];
    s2 += T(-0.5) * (zy * zy + log_2pi) - d_log(sigma[j]);
  }
  return lp + s2;
}

// Neal's funnel at one sample x = [mu, log_sigma], in the order of
// viabel_tpu/models/funnel.py:14-18: log_sigma ~ N(0, s) and
// mu ~ N(0, exp(log_sigma)); s and log(s) come from the host (d = 2).
template <typename T, int MAXD>
__device__ __forceinline__ T funnel(const T (&x)[MAXD],
                                    const ModelArgs<T>& m) {
  static_assert(MAXD >= 2, "the funnel needs d = 2");
  const T log_2pi = T(LOG_2PI);
  T mu = x[0], log_sigma = x[1];
  T zs = log_sigma / m.prior_std;
  T lp = T(-0.5) * (zs * zs + log_2pi) - m.log_prior;
  T sigma = d_exp(log_sigma);
  T zm = mu / sigma;
  return lp + (T(-0.5) * (zm * zm + log_2pi) - d_log(sigma));
}

template <typename T, int MAXD>
__device__ __forceinline__ T model_log_density(const T (&x)[MAXD], int d,
                                               const T* s_a, const T* s_b,
                                               const ModelArgs<T>& m) {
  switch (m.kind) {
    case REGRESSION:
      return regression<T, MAXD>(x, d, s_a, s_b, m);
    case EIGHT_SCHOOLS_NCP:
      return eight_schools_ncp<T, MAXD>(x, s_a, s_b);
    case FUNNEL:
      return funnel<T, MAXD>(x, m);
    default:
      return eight_schools_cp<T, MAXD>(x, s_a, s_b);
  }
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon, Moraes, Dror & Shaw 2011; Random123's constants)
// and Box-Muller.  The stream of a (seed, offset) pair: sample s, group g
// of 4 normals runs Philox with key (seed lo, seed hi) and counter
// (s lo, g, offset, s hi); its 4 words become 4 uniforms in (2^-24, 1]
// (24 bits each, as the TPU kernel's _uniform_from_bits), and the pairs
// (u0, u1), (u2, u3) become normals (r cos, r sin) with
// r = sqrt(-2 log u_first), angle 2 pi u_second.  ops/philox.py holds the
// plain version of the same stream.
// ---------------------------------------------------------------------------

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 philox_group(uint64_t sample, uint32_t group,
                                              uint32_t offset, uint2 key) {
  return philox4x32_10(make_uint4(uint32_t(sample), group, offset,
                                  uint32_t(sample >> 32)),
                       key);
}

template <typename T>
__device__ __forceinline__ T uniform_from_bits(uint32_t bits) {
  return T(1) - T(bits >> 8) * T(1.0 / 16777216.0);
}

template <typename T>
__device__ __forceinline__ void box_muller(uint32_t b0, uint32_t b1, T& z0,
                                           T& z1) {
  T r = d_sqrt(T(-2) * d_log(uniform_from_bits<T>(b0)));
  T s, c;
  d_sincos(T(TWO_PI) * uniform_from_bits<T>(b1), &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// The 4 normals of group g, written to z[4g..4g+3] where below d.
template <typename T, int MAXD>
__device__ __forceinline__ void philox_normals(uint64_t sample,
                                               uint32_t offset, uint2 key,
                                               int d, T (&z)[MAXD]) {
#pragma unroll
  for (int g = 0; g < (MAXD + 3) / 4; ++g) {
    if (4 * g < d) {
      uint4 b = philox_group(sample, uint32_t(g), offset, key);
      T n0, n1, n2, n3;
      box_muller(b.x, b.y, n0, n1);
      box_muller(b.z, b.w, n2, n3);
      z[4 * g] = n0;
      if (4 * g + 1 < d) z[4 * g + 1] = n1;
      if (4 * g + 2 < d) z[4 * g + 2] = n2;
      if (4 * g + 3 < d) z[4 * g + 3] = n3;
    }
  }
}

// ---------------------------------------------------------------------------
// Base draws of the score kernel: each fills z[0..d) for sample i and
// returns the base log density of z summed over the d coordinates.
// ---------------------------------------------------------------------------

// K1: z read from device memory, standard normal or Student-t(df) base
template <typename T>
struct LoadedDraws {
  const T* z;
  int student_t;
  T df, t_lognorm;

  template <int MAXD>
  __device__ __forceinline__ T operator()(int64_t i, int d,
                                          T (&out)[MAXD]) const {
    const T* zi = z + i * d;
    T lp = T(0);
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j < d) {
        T zj = zi[j];
        out[j] = zj;
        if (student_t)
          lp += t_lognorm - T(0.5) * (df + T(1)) * d_log1p(zj * zj / df);
        else
          lp += zj * zj + T(LOG_2PI);
      }
    }
    return student_t ? lp : T(-0.5) * lp;
  }
};

// K2: standard normal z made in registers from the Philox stream
template <typename T>
struct PhiloxDraws {
  uint2 key;
  uint32_t offset;

  template <int MAXD>
  __device__ __forceinline__ T operator()(int64_t i, int d,
                                          T (&out)[MAXD]) const {
    philox_normals<T, MAXD>(uint64_t(i), offset, key, d, out);
    T ss = T(0);
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) ss += out[j] * out[j] + T(LOG_2PI);
    return T(-0.5) * ss;
  }
};

// Shared memory the score kernel stages: mean, exp(log_scale) (MAXD each),
// then the model's a and b arrays.
template <typename T, int MAXD>
inline size_t score_smem_bytes(const ModelArgs<T>& m, int d) {
  return sizeof(T) * (2 * MAXD + m.n_a(d) + m.n_b());
}

// The score kernel of K1 and K2: x = mean + exp(log_scale) z,
// lw = log p(x) - log q(x) with log q = base log density of z minus
// sum(log_scale); lw is written and reduced to one partials row per chunk.
// One thread per sample (ITEMS samples a thread, THREADS apart),
// grid-stride over chunks.  With D_FIXED > 0 the dimension is that
// compile-time constant and every `j < d` guard folds away; with
// D_FIXED = 0 it is the runtime d_arg <= MAXD.
template <typename T, int MAXD, int D_FIXED, class Draws>
__global__ void __launch_bounds__(THREADS)
    score_partials_kernel(Draws draws, const T* __restrict__ mean,
                          const T* __restrict__ log_scale, int d_arg,
                          ModelArgs<T> model, int64_t n, int64_t n_chunks,
                          T alpha, T* __restrict__ lw,
                          T* __restrict__ partials) {
  const int d = D_FIXED > 0 ? D_FIXED : d_arg;
  __shared__ SharedStats<T> sh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_mean = reinterpret_cast<T*>(smem_raw);
  T* s_scale = s_mean + MAXD;
  T* s_a = s_scale + MAXD;
  T* s_b = s_a + model.n_a(d);
  for (int j = threadIdx.x; j < MAXD; j += THREADS) {
    s_mean[j] = j < d ? mean[j] : T(0);
    s_scale[j] = j < d ? d_exp(log_scale[j]) : T(0);
  }
  for (int j = threadIdx.x; j < model.n_a(d); j += THREADS)
    s_a[j] = model.a[j];
  for (int j = threadIdx.x; j < model.n_b(); j += THREADS)
    s_b[j] = model.b[j];
  T sum_log_scale = T(0);
  for (int j = 0; j < d; ++j) sum_log_scale += log_scale[j];
  __syncthreads();

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int64_t base = c * CHUNK;
    T v[ITEMS];
    bool ok[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int64_t i = base + int64_t(k) * THREADS + threadIdx.x;
      ok[k] = i < n;
      v[k] = T(0);
      if (!ok[k]) continue;
      T x[MAXD];
      T logq = draws(i, d, x) - sum_log_scale;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) x[j] = s_mean[j] + s_scale[j] * x[j];
      v[k] = model_log_density<T, MAXD>(x, d, s_a, s_b, model) - logq;
      lw[i] = v[k];
    }
    chunk_partials(v, ok, alpha, sh, partials + c * NPART);
  }
}

inline int64_t chunks_of(int64_t n) { return (n + CHUNK - 1) / CHUNK; }
inline int grid_of(int64_t n_chunks) {
  return int(n_chunks < MAX_GRID ? n_chunks : MAX_GRID);
}

// Launch one instance of the score kernel.
template <typename T, int MAXD, int D_FIXED, class Draws>
int launch_score_at(const Draws& draws, const void* mean,
                    const void* log_scale, int d, const ModelSpec* spec,
                    long long n, double alpha, void* lw, void* partials,
                    void* stream) {
  ModelArgs<T> model(*spec);
  size_t smem = score_smem_bytes<T, MAXD>(model, d);
  auto kernel = score_partials_kernel<T, MAXD, D_FIXED, Draws>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int64_t nc = chunks_of(n);
  kernel<<<grid_of(nc), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      draws, static_cast<const T*>(mean), static_cast<const T*>(log_scale), d,
      model, n, nc, T(alpha), static_cast<T*>(lw), static_cast<T*>(partials));
  return int(cudaGetLastError());
}

// d = 10 (eight-schools CP and NCP, the regression path's D) runs a
// compile-time instance, measured faster than the runtime one (PERF.md);
// any other d (the funnel's 2) the runtime instance of MAX_DIM.
template <typename T, class Draws>
int launch_score(const Draws& draws, const void* mean, const void* log_scale,
                 int d, const ModelSpec* spec, long long n, double alpha,
                 void* lw, void* partials, void* stream) {
  if (d < 1 || d > MAX_DIM) return int(cudaErrorInvalidValue);
  if (d == 10)
    return launch_score_at<T, 10, 10>(draws, mean, log_scale, d, spec, n,
                                      alpha, lw, partials, stream);
  return launch_score_at<T, MAX_DIM, 0>(draws, mean, log_scale, d, spec, n,
                                        alpha, lw, partials, stream);
}

}  // namespace bound_pass

// Every library built from csrc/ reports the layout it was compiled with;
// ops/lw_stats.py checks it at load (each .cu is its own library, so these
// definitions are made once per library).
extern "C" {
int bound_pass_chunk(void) { return bound_pass::CHUNK; }
int bound_pass_max_dim(void) { return bound_pass::MAX_DIM; }
int bound_pass_model_spec_size(void) {
  return int(sizeof(bound_pass::ModelSpec));
}
}  // extern "C"
