// Log-weight kernels of the validated-VI bound pass, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes; the Python wrappers live in
// viabel_tpu_torch/ops/lw_stats.py beside their plain PyTorch versions.
//
// Kernels (each a template over float and double):
//
// * transform_score_partials (K1) replaces the TPU kernel
//   fused_location_scale_lw_stats (viabel_tpu/ops/sample_score.py:333-385
//   at 2e6dc2c^): x = mean + exp(log_scale) * z, lw = log p(x) - log q(x)
//   with log q from the base density of z, then per-chunk partial
//   statistics of lw.
// * lw_partials (K3) replaces streaming_lw_stats
//   (viabel_tpu/ops/sample_score.py:108-142 at 2e6dc2c^): the same
//   per-chunk partials over an existing lw vector.
// * combine_partials replaces the _combine_tiles epilogue
//   (viabel_tpu/ops/sample_score.py:67-91 at 2e6dc2c^).
//
// What bounds them on an H100: K1 and K3 are bound by bytes (K1 reads z,
// 40 B a sample in f32, and writes lw, 4 B: 33 us at 3.35 TB/s for 2.5e6
// samples; its ~230 operations a sample take 9 us at the 67 TFLOP/s f32
// rate).  The design
// reads each input once with warp-contiguous addresses, keeps the chunk's
// log-weights in registers between the score and the statistics, and writes
// only lw and one 6-value partial per chunk, so device memory sees the bytes
// the function must move and no more.  combine_partials reads a few KB in
// one block; its time is launch latency.
//
// Partials layout, one row of 6 values per chunk of CHUNK consecutive
// samples (the last chunk may be ragged):
//   [count, m, mean_e, M2_e, mean_lw, M2_lw]
// with m the chunk max of lw, e = exp(lw - m)^alpha, mean/M2 the mean and
// sum of squared deviations.  Welford's update within a thread and Chan's
// rule across threads and chunks: the one-pass sum-of-squares form cancels
// in f32 and is never used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int NPART = 6;
constexpr int COMBINE_THREADS = 512;
constexpr int MAX_GRID = 4096;

constexpr int DIM = 10;  // eight-schools CP: mu, log_tau, theta[8]
constexpr int J = 8;

constexpr double LOG_2PI = 1.8378770664093453;
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

// log density of the centred eight-schools model at one sample, in the
// order of viabel_tpu/models/eight_schools.py:70-78
template <typename T>
__device__ __forceinline__ T eight_schools_cp(const T (&x)[DIM],
                                              const T* __restrict__ y,
                                              const T* __restrict__ sigma) {
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

// K1: one thread per sample (ITEMS samples a thread, THREADS apart, so a
// warp reads 32 consecutive rows of z), grid-stride over chunks.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    transform_score_partials_kernel(const T* __restrict__ z,
                                    const T* __restrict__ mean,
                                    const T* __restrict__ log_scale,
                                    const T* __restrict__ y,
                                    const T* __restrict__ sigma, int64_t n,
                                    int64_t n_chunks, int base_kind, T df,
                                    T t_lognorm, T alpha, T* __restrict__ lw,
                                    T* __restrict__ partials) {
  __shared__ SharedStats<T> sh;
  T mu_q[DIM], scale[DIM];
  T sum_log_scale = T(0);
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    mu_q[k] = mean[k];
    scale[k] = d_exp(log_scale[k]);
    sum_log_scale += log_scale[k];
  }
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
      const T* zi = z + i * DIM;
      T x[DIM];
      T base_lp = T(0);
      if (base_kind == 1) {  // Student-t(df) base
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          T zd = zi[d];
          x[d] = mu_q[d] + scale[d] * zd;
          base_lp += t_lognorm - T(0.5) * (df + T(1)) * d_log1p(zd * zd / df);
        }
      } else {  // standard normal base
        T ss = T(0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          T zd = zi[d];
          x[d] = mu_q[d] + scale[d] * zd;
          ss += zd * zd + T(LOG_2PI);
        }
        base_lp = T(-0.5) * ss;
      }
      T logq = base_lp - sum_log_scale;
      v[k] = eight_schools_cp(x, y, sigma) - logq;
      lw[i] = v[k];
    }
    chunk_partials(v, ok, alpha, sh, partials + c * NPART);
  }
}

// K3: the same partials over an existing lw vector.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    lw_partials_kernel(const T* __restrict__ lw, int64_t n, int64_t n_chunks,
                       T alpha, T* __restrict__ partials) {
  __shared__ SharedStats<T> sh;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int64_t base = c * CHUNK;
    T v[ITEMS];
    bool ok[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      int64_t i = base + int64_t(k) * THREADS + threadIdx.x;
      ok[k] = i < n;
      v[k] = ok[k] ? lw[i] : T(0);
    }
    chunk_partials(v, ok, alpha, sh, partials + c * NPART);
  }
}

// combine: one block.  Rescale each chunk to the global max M with
// r_b = exp(m_b - M)^alpha (mean by r_b, M2 by r_b^2; an r_b that
// underflows to 0 leaves a finite zero-weight group), merge by Chan's rule,
// and write [M, mean_e, std_e, mean_lw, std_lw] with population std.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_partials_kernel(const T* __restrict__ partials, int64_t n_chunks,
                            T alpha, T* __restrict__ out) {
  __shared__ T s_max[COMBINE_THREADS];
  __shared__ double s_n[COMBINE_THREADS];
  __shared__ T s_me[COMBINE_THREADS], s_m2e[COMBINE_THREADS];
  __shared__ T s_ml[COMBINE_THREADS], s_m2l[COMBINE_THREADS];
  int tid = threadIdx.x;
  T tmax = T(-INFINITY);
  for (int64_t b = tid; b < n_chunks; b += COMBINE_THREADS)
    tmax = nan_max(tmax, partials[b * NPART + 1]);
  T M = block_max<T, COMBINE_THREADS>(tmax, s_max);

  double n = 0.0, n2 = 0.0;
  T me = T(0), m2e = T(0), ml = T(0), m2l = T(0);
  for (int64_t b = tid; b < n_chunks; b += COMBINE_THREADS) {
    const T* row = partials + b * NPART;
    T r = pow_alpha(row[1] - M, alpha);
    double nb = double(row[0]);
    chan(n, me, m2e, nb, row[2] * r, row[3] * r * r);
    chan(n2, ml, m2l, nb, row[4], row[5]);
  }
  block_chan<T, COMBINE_THREADS>(n, me, m2e, ml, m2l, s_n, s_me, s_m2e, s_ml,
                                 s_m2l);
  if (tid == 0) {
    out[0] = M;
    out[1] = me;
    out[2] = d_sqrt(m2e / T(n));
    out[3] = ml;
    out[4] = d_sqrt(m2l / T(n));
  }
}

int64_t chunks_of(int64_t n) { return (n + CHUNK - 1) / CHUNK; }
int grid_of(int64_t n_chunks) {
  return int(n_chunks < MAX_GRID ? n_chunks : MAX_GRID);
}

template <typename T>
int launch_transform_score(const void* z, const void* mean,
                           const void* log_scale, const void* y,
                           const void* sigma, long long n, int base_kind,
                           double df, double t_lognorm, double alpha, void* lw,
                           void* partials, void* stream) {
  int64_t nc = chunks_of(n);
  transform_score_partials_kernel<T>
      <<<grid_of(nc), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(z), static_cast<const T*>(mean),
          static_cast<const T*>(log_scale), static_cast<const T*>(y),
          static_cast<const T*>(sigma), n, nc, base_kind, T(df), T(t_lognorm),
          T(alpha), static_cast<T*>(lw), static_cast<T*>(partials));
  return int(cudaGetLastError());
}

template <typename T>
int launch_lw_partials(const void* lw, long long n, double alpha,
                       void* partials, void* stream) {
  int64_t nc = chunks_of(n);
  lw_partials_kernel<T>
      <<<grid_of(nc), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(lw), n, nc, T(alpha),
          static_cast<T*>(partials));
  return int(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* partials, long long n_chunks, double alpha,
                   void* out, void* stream) {
  combine_partials_kernel<T>
      <<<1, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(partials), n_chunks, T(alpha),
          static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int lw_stats_chunk(void) { return CHUNK; }
int lw_stats_dim(void) { return DIM; }

int transform_score_partials_f32(const void* z, const void* mean,
                                 const void* log_scale, const void* y,
                                 const void* sigma, long long n, int base_kind,
                                 double df, double t_lognorm, double alpha,
                                 void* lw, void* partials, void* stream) {
  return launch_transform_score<float>(z, mean, log_scale, y, sigma, n,
                                       base_kind, df, t_lognorm, alpha, lw,
                                       partials, stream);
}

int transform_score_partials_f64(const void* z, const void* mean,
                                 const void* log_scale, const void* y,
                                 const void* sigma, long long n, int base_kind,
                                 double df, double t_lognorm, double alpha,
                                 void* lw, void* partials, void* stream) {
  return launch_transform_score<double>(z, mean, log_scale, y, sigma, n,
                                        base_kind, df, t_lognorm, alpha, lw,
                                        partials, stream);
}

int lw_partials_f32(const void* lw, long long n, double alpha, void* partials,
                    void* stream) {
  return launch_lw_partials<float>(lw, n, alpha, partials, stream);
}

int lw_partials_f64(const void* lw, long long n, double alpha, void* partials,
                    void* stream) {
  return launch_lw_partials<double>(lw, n, alpha, partials, stream);
}

int combine_partials_f32(const void* partials, long long n_chunks,
                         double alpha, void* out, void* stream) {
  return launch_combine<float>(partials, n_chunks, alpha, out, stream);
}

int combine_partials_f64(const void* partials, long long n_chunks,
                         double alpha, void* out, void* stream) {
  return launch_combine<double>(partials, n_chunks, alpha, out, stream);
}

}  // extern "C"
