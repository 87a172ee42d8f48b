// Shared device code of the bound-pass kernels, for Hopper (sm_90a):
// the per-chunk statistics, the model log densities (eight-schools CP
// and NCP, the funnel, Bayesian regression), the Philox4x32-10 stream
// with Box-Muller, and the score kernel that K1 (lw_stats.cu, external
// draws) and K2 (gaussian_lw.cu, draws made in-kernel) both
// instantiate.  ops/_build.py hashes this header into every library
// built from csrc/, so an edit here rebuilds both.
//
// The score kernel's design for this card.  A sample costs several hundred
// instructions against 4 d + 4 bytes, so the kernel is bound by the rate
// at which the SMs issue instructions, not by device memory (PERF.md has
// the times).  Hence: what does not depend on the sample is computed once
// a launch (reciprocals of sigma, tau's per sample, of df and of the
// scales; the summed log sigma); the Student-t base takes one logarithm
// for two coordinates; K1's z (d = 10) comes through a pair of
// shared-memory sub-tiles filled by 16-byte cp.async copies, every lane on
// the next 16 bytes, each warp copying the rows its own lanes will score
// (so a warp barrier suffices) while it scores the sub-tile before, and
// each thread then reads its row as 8- or 16-byte words; d = 2 has its own
// instance and reads a row as one word; a regression's rows are staged
// padded, [x_k, y_k, 0 ..] to whole 16-byte words, so that every row
// starts on 16 bytes and is read as 16-byte broadcasts, the used values
// only (x beta's issue slots are the bulk of K2's work at N = 100, d = 10;
// PERF.md has why two samples a pass over the rows did not pay); a chunk's
// statistics merge by warp shuffles with two block barriers, and full
// chunks, whose groups have equal counts, merge without a division; the
// grid is what the card holds at once, each block walking chunks in a
// stride.
//
// Partials layout, one row of NPART values per chunk of CHUNK consecutive
// samples (the last chunk may be ragged):
//   [count, m, mean_e, M2_e, mean_lw, M2_lw]
// with m the chunk max of lw, e = exp(lw - m)^alpha, mean/M2 the mean and
// sum of squared deviations.  Within a thread two passes over its values
// and Chan's rule across threads and chunks: the one-pass sum-of-squares
// form cancels in f32 and is never used.  A log-weight of -inf or +inf
// gives the reference's statistics (viabel_tpu/bounds.py:124-156): mean_lw
// the IEEE mean, std_lw NaN, and the e's as exp(lw - max) gives them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bound_pass {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int NPART = 6;
constexpr int MAX_DIM = 32;  // the largest d a score kernel takes
constexpr int SCHOOLS = 8;   // J of the eight-schools densities
// the model data a score kernel stages beside mean and scale, in bytes;
// equals MAX_STAGED_BYTES in ops/limits.py
constexpr int MAX_STAGED_BYTES = 96 * 1024;
// K1's double buffer: one sub-tile of THREADS rows of z in flight while
// the other is scored
constexpr int STAGES = 2;
// blocks an SM must hold of a compile-time-d instance (64 registers a
// thread at 4) and of the runtime-d one, whose 32-slot arrays need more
constexpr int MIN_BLOCKS_FIXED_D = 4;
constexpr int MIN_BLOCKS_RUNTIME_D = 2;
static_assert(ITEMS % STAGES == 0, "a chunk starts in slot 0");
constexpr int MAX_DEVICES = 64;

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

// N values of T as one aligned word of 4, 8 or 16 bytes
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

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

// ---------------------------------------------------------------------------
// A chunk's statistics (K1, K2 and K3), by warp shuffles with two block
// barriers a chunk, and the combine of the chunks' rows, by the same
// shuffles in one block.
// ---------------------------------------------------------------------------

// Chan's rule on whole Moments, counts in T: merge b into a.  A chunk's
// counts are at most CHUNK, exact in float; the combine's reach n, and in
// float the ratios then round like any other value (relative 6e-8).
// Where either mean of lw is infinite (a log-weight of -inf or +inf), the
// merged mean is their sum, the mean in IEEE arithmetic (-inf with -inf,
// NaN with both signs), where Chan's form would give inf - inf = NaN; such
// a group's M2 is NaN already, as jnp.std is.  The e's are finite or NaN.
template <typename T>
__device__ __forceinline__ void merge(Moments<T>& a, const Moments<T>& b) {
  if (b.count == T(0)) return;
  T n = a.count + b.count;
  T wb = b.count / n, wab = a.count * b.count / n;
  T de = b.mean_e - a.mean_e, dl = b.mean_lw - a.mean_lw;
  a.mean_e += de * wb;
  a.m2_e = (a.m2_e + b.m2_e) + de * de * wab;
  a.mean_lw = isinf(a.mean_lw) || isinf(b.mean_lw) ? a.mean_lw + b.mean_lw
                                                   : a.mean_lw + dl * wb;
  a.m2_lw = (a.m2_lw + b.m2_lw) + dl * dl * wab;
  a.count = n;
}

// The same for two groups of one count c: n_b / n = 1 / 2 and
// n_a n_b / n = c / 2, so no division; symmetric in a and b, and its mean
// (a + b) / 2 is already the IEEE one with infinite means.
template <typename T>
__device__ __forceinline__ void merge_equal(Moments<T>& a,
                                            const Moments<T>& b) {
  T half = T(0.5) * a.count;
  T de = b.mean_e - a.mean_e, dl = b.mean_lw - a.mean_lw;
  a.mean_e = T(0.5) * (a.mean_e + b.mean_e);
  a.m2_e = (a.m2_e + b.m2_e) + de * de * half;
  a.mean_lw = T(0.5) * (a.mean_lw + b.mean_lw);
  a.m2_lw = (a.m2_lw + b.m2_lw) + dl * dl * half;
  a.count += a.count;
}

// Either of the two: no division where the counts agree (two full chunks,
// or two groups of as many full chunks).  Used where a thread merges groups
// one after another; a butterfly keeps one rule for the whole warp, since
// a warp whose lanes split between the two pays for both.
template <typename T>
__device__ __forceinline__ void merge_any(Moments<T>& a, const Moments<T>& b) {
  if (a.count == b.count)
    merge_equal(a, b);
  else
    merge(a, b);
}

// Butterfly of merges over the first WIDTH lanes of a warp (every lane of
// the warp takes part in the shuffles); every one of those lanes ends with
// the merged group.  EQUAL: all groups have one count.
template <typename T, bool EQUAL, int WIDTH>
__device__ __forceinline__ Moments<T> warp_merge(Moments<T> s) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < WIDTH; k <<= 1) {
    Moments<T> o;
    o.count = __shfl_xor_sync(all, s.count, k);
    o.mean_e = __shfl_xor_sync(all, s.mean_e, k);
    o.m2_e = __shfl_xor_sync(all, s.m2_e, k);
    o.mean_lw = __shfl_xor_sync(all, s.mean_lw, k);
    o.m2_lw = __shfl_xor_sync(all, s.m2_lw, k);
    if (EQUAL) {
      merge_equal(s, o);
    } else {
      if (lane & k) {  // both lanes merge the upper group into the lower
        Moments<T> t = s;
        s = o;
        o = t;
      }
      merge(s, o);
    }
  }
  return s;
}

template <typename T>
struct WarpStats {  // one slot a warp
  T max_buf[WARPS];
  T count[WARPS], me[WARPS], m2e[WARPS], ml[WARPS], m2l[WARPS];
};

// The block's max (NaN propagates) of every thread's m, in every thread:
// shuffles within a warp, then one barrier.
template <typename T>
__device__ __forceinline__ T block_nan_max(T m, WarpStats<T>& sh) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    m = nan_max(m, __shfl_xor_sync(all, m, k));
  if (lane == 0) sh.max_buf[warp] = m;
  __syncthreads();
  m = sh.max_buf[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = nan_max(m, sh.max_buf[w]);
  return m;
}

// The block's merged group of every thread's s, in the lanes of warp 0
// (butterflies within each warp, one barrier, a butterfly over the warps).
template <typename T, bool EQUAL>
__device__ __forceinline__ Moments<T> block_merge(Moments<T> s,
                                                  WarpStats<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_merge<T, EQUAL, 32>(s);
  if (lane == 0) {
    sh.count[warp] = s.count;
    sh.me[warp] = s.mean_e;
    sh.m2e[warp] = s.m2_e;
    sh.ml[warp] = s.mean_lw;
    sh.m2l[warp] = s.m2_lw;
  }
  __syncthreads();
  Moments<T> w = {T(0), T(0), T(0), T(0), T(0)};
  if (warp == 0) {
    if (lane < WARPS) {
      w.count = sh.count[lane];
      w.mean_e = sh.me[lane];
      w.m2_e = sh.m2e[lane];
      w.mean_lw = sh.ml[lane];
      w.m2_lw = sh.m2l[lane];
    }
    w = warp_merge<T, EQUAL, WARPS>(w);
  }
  return w;
}

// The chunk's partial row from the log-weights each thread holds in
// registers.  A thread's moments come from two passes over its registers
// (sums, then squared deviations), so an infinite value gives the IEEE
// mean and a NaN M2.  FULL: every v[k] is valid, so all groups have equal
// counts at every level and no merge divides; else v[k] is valid where
// ok[k] (a thread may hold none) and the general rules apply.  The e's of
// a chunk whose max is -inf (every value -inf) are taken against 0, so
// they are 0, as against any finite global max; the combine's r_b then
// decides (0 against a finite max, NaN against -inf, as the reference's
// exp(lw - max) is).
template <typename T, bool FULL>
__device__ __forceinline__ void chunk_partials_of(const T (&v)[ITEMS],
                                                  const bool (&ok)[ITEMS],
                                                  T alpha, WarpStats<T>& sh,
                                                  T* out_row) {
  T m = T(-INFINITY);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (FULL || ok[k]) m = nan_max(m, v[k]);
  m = block_nan_max(m, sh);
  const T m_e = m == T(-INFINITY) ? T(0) : m;

  Moments<T> s = {T(0), T(0), T(0), T(0), T(0)};
  T e[ITEMS];
  T sum_e = T(0), sum_lw = T(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (FULL || ok[k]) {
      e[k] = pow_alpha(v[k] - m_e, alpha);
      sum_e += e[k];
      sum_lw += v[k];
      s.count += T(1);
    }
  }
  if (FULL || s.count > T(0)) {
    const T inv = FULL ? T(1.0 / ITEMS) : T(1) / s.count;
    s.mean_e = sum_e * inv;
    s.mean_lw = sum_lw * inv;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (FULL || ok[k]) {
        T de = e[k] - s.mean_e, dl = v[k] - s.mean_lw;
        s.m2_e = d_fma(de, de, s.m2_e);
        s.m2_lw = d_fma(dl, dl, s.m2_lw);
      }
    }
  }
  Moments<T> w = block_merge<T, FULL>(s, sh);
  if (threadIdx.x == 0) {
    out_row[0] = w.count;
    out_row[1] = m;
    out_row[2] = w.mean_e;
    out_row[3] = w.m2_e;
    out_row[4] = w.mean_lw;
    out_row[5] = w.m2_lw;
  }
}

// The partial row of the chunk of samples [base, base + CHUNK) of n.
template <typename T>
__device__ __forceinline__ void chunk_partials(const T (&v)[ITEMS],
                                               const bool (&ok)[ITEMS],
                                               int64_t base, int64_t n,
                                               T alpha, WarpStats<T>& sh,
                                               T* out_row) {
  if (base + CHUNK <= n)
    chunk_partials_of<T, true>(v, ok, alpha, sh, out_row);
  else
    chunk_partials_of<T, false>(v, ok, alpha, sh, out_row);
}

// The combine, by one block: the n_chunks partial rows to [M, mean_e,
// std_e, mean_lw, std_lw] (population std).  Thread t takes rows t,
// t + THREADS, ...; first the global max M by shuffles, then each row is
// rescaled by r_b = exp(m_b - M)^alpha (mean by r_b, M2 by r_b^2; an r_b
// that underflows to 0 leaves a finite zero-weight group) and merged, in
// the thread (every row but the ragged last holds CHUNK samples, so a
// thread's first two rows, or any two groups of as many full rows, merge
// without a division) and then by the butterflies of block_merge.  NaN
// propagates through M.  Its time is a chain of dependent steps, the
// longest of them the trips to memory: a thread loads its first
// ROWS_KEPT rows whole at once and keeps them in registers for the merge,
// so up to THREADS x ROWS_KEPT rows (the paths' 1221 and 489) take one
// trip; rows beyond that are read again after the max.  The loops are not
// unrolled: the code runs once, often not yet in any cache.
constexpr int ROWS_KEPT = 5;

// rows b0, b0 + THREADS, ... (ROWS_KEPT of them) whole; count 0 past the
// last
template <typename T>
__device__ __forceinline__ void load_rows(const T* partials,
                                          int64_t n_chunks, int64_t b0,
                                          T (&row)[ROWS_KEPT][NPART]) {
#pragma unroll
  for (int u = 0; u < ROWS_KEPT; ++u) {
    int64_t b = b0 + int64_t(u) * THREADS;
#pragma unroll
    for (int j = 0; j < NPART; ++j)
      row[u][j] = b < n_chunks ? partials[b * NPART + j] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void combine_rows(const T* partials,
                                             int64_t n_chunks, T alpha,
                                             WarpStats<T>& sh, T* out) {
  constexpr int64_t STEP = int64_t(ROWS_KEPT) * THREADS;
  T row[ROWS_KEPT][NPART];
  load_rows(partials, n_chunks, threadIdx.x, row);
  T m = T(-INFINITY);
#pragma unroll
  for (int u = 0; u < ROWS_KEPT; ++u)
    if (row[u][0] != T(0)) m = nan_max(m, row[u][1]);
#pragma unroll 1
  for (int64_t b = threadIdx.x + STEP; b < n_chunks; b += THREADS)
    m = nan_max(m, partials[b * NPART + 1]);
  m = block_nan_max(m, sh);

  Moments<T> s = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int64_t b0 = threadIdx.x; b0 < n_chunks; b0 += STEP) {
    if (b0 != threadIdx.x) load_rows(partials, n_chunks, b0, row);
#pragma unroll
    for (int u = 0; u < ROWS_KEPT; ++u) {
      if (row[u][0] == T(0)) continue;  // past the last row
      T r = pow_alpha(row[u][1] - m, alpha);
      Moments<T> g = {row[u][0], row[u][2] * r, row[u][3] * r * r,
                      row[u][4], row[u][5]};
      if (s.count == T(0))
        s = g;
      else
        merge_any(s, g);
    }
  }
  Moments<T> w = block_merge<T, false>(s, sh);
  if (threadIdx.x == 0) {
    out[0] = m;
    out[1] = w.mean_e;
    out[2] = d_sqrt(w.m2_e / w.count);
    out[3] = w.mean_lw;
    out[4] = d_sqrt(w.m2_lw / w.count);
  }
}

// ---------------------------------------------------------------------------
// Model log densities.  The model's data sits in shared memory (staged by
// the score kernel) with what the kernel derives from it once a launch
// (ModelConsts); the sample in registers.
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

// A regression row as staged: x_k0 .. x_k(d-1), y_k, then zeros to a whole
// number of 16-byte words, so that every row starts on 16 bytes: 12
// values at d = 10 in float and in double; equals regression_row in
// ops/limits.py.
template <typename T>
__host__ __device__ constexpr int regression_row(int d) {
  constexpr int W = 16 / int(sizeof(T));
  return (d + 1 + W - 1) / W * W;
}

// out[O..N) from p (16-byte aligned) by the widest aligned words that
// hold only those values: 16 bytes while a whole one fits, then 8, then
// one value (x_k, y_k at d = 10 in float: 16 + 16 + 8 + 4 bytes).  The
// pad is never loaded, so it costs no register.
template <typename T, int N, int O = 0>
__device__ __forceinline__ void read_words(const T* p, T (&out)[N]) {
  if constexpr (O < N) {
    constexpr int V16 = 16 / int(sizeof(T)), V8 = 8 / int(sizeof(T));
    constexpr int W = N - O >= V16 ? V16 : N - O >= V8 ? V8 : 1;
    Pack<T, W> word = *reinterpret_cast<const Pack<T, W>*>(p + O);
#pragma unroll
    for (int e = 0; e < W; ++e) out[O + e] = word.v[e];
    read_words<T, N, O + W>(p, out);
  }
}

template <typename T>
struct ModelArgs {
  int kind, n_rows, student_t;
  const T* a;
  const T* b;
  T df, half_df1, lik_lognorm, noise_scale, log_noise, prior_std, log_prior;
  // reciprocals, taken once on the host in double (0 where unused)
  T inv_df, inv_noise, inv_prior;

  __host__ explicit ModelArgs(const ModelSpec& m)
      : kind(m.kind), n_rows(m.n_rows), student_t(m.student_t),
        a(static_cast<const T*>(m.a)), b(static_cast<const T*>(m.b)),
        df(T(m.df)), half_df1(T(m.half_df1)), lik_lognorm(T(m.lik_lognorm)),
        noise_scale(T(m.noise_scale)), log_noise(T(m.log_noise)),
        prior_std(T(m.prior_std)), log_prior(T(m.log_prior)),
        inv_df(T(m.df > 0.0 ? 1.0 / m.df : 0.0)),
        inv_noise(T(m.noise_scale > 0.0 ? 1.0 / m.noise_scale : 0.0)),
        inv_prior(T(m.prior_std > 0.0 ? 1.0 / m.prior_std : 0.0)) {}

  // values staged in shared memory after the mean and scale: eight-schools'
  // y (sigma enters through ModelConsts), a regression's padded rows
  __host__ __device__ int staged_values(int d) const {
    return kind == REGRESSION ? n_rows * regression_row<T>(d)
           : schools()        ? n_rows
                              : 0;
  }
  __host__ __device__ bool schools() const {
    return kind == EIGHT_SCHOOLS_CP || kind == EIGHT_SCHOOLS_NCP;
  }
};

// What a block derives from the staged data once a launch: eight-schools'
// 1 / sigma_j and sum_j log sigma_j.
template <typename T>
struct ModelConsts {
  T inv_sigma[SCHOOLS];
  T sum_log_sigma;
};

// The priors both eight-schools densities share: mu ~ N(0, 5) and
// tau ~ half-Cauchy(0, 5) on tau = exp(log_tau), with its log-Jacobian.
template <typename T>
__device__ __forceinline__ T schools_prior(T mu, T log_tau, T tau) {
  T zmu = mu * T(0.2);
  T ts = tau * T(0.2);
  return T(-0.5) * (zmu * zmu + T(LOG_2PI)) - T(LOG_5) -
         d_log(T(PI_5) * (T(1) + ts * ts)) + log_tau;
}

// sum_j of a unit-free N(theta_j, sigma_j) log density of y_j from the sum
// of squared z: -ss / 2 - J log(2 pi) / 2 - sum_j log sigma_j
template <typename T>
__device__ __forceinline__ T schools_sum(T ss, T sum_log_scale) {
  return T(-0.5) * ss - (T(0.5 * SCHOOLS * LOG_2PI) + sum_log_scale);
}

// Centred eight-schools at one sample, the density of
// viabel_tpu/models/eight_schools.py:70-78 (d = 10, J = 8), with one
// reciprocal of tau a sample and the launch's 1 / sigma_j and summed
// log sigma_j.
template <typename T, int MAXD>
__device__ __forceinline__ T eight_schools_cp(const T (&x)[MAXD],
                                              const T* y,
                                              const ModelConsts<T>& k) {
  static_assert(MAXD >= 2 + SCHOOLS, "eight-schools CP needs d = 10");
  T mu = x[0], log_tau = x[1];
  T tau = d_exp(log_tau);
  T inv_tau = T(1) / tau;
  T lp = schools_prior(mu, log_tau, tau);
  T log_scale_tau = d_log(tau);  // log(exp(log_tau)), as the JAX density
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int j = 0; j < SCHOOLS; ++j) {
    T zt = (x[2 + j] - mu) * inv_tau;
    s1 = d_fma(zt, zt, s1);
    T zy = (y[j] - x[2 + j]) * k.inv_sigma[j];
    s2 = d_fma(zy, zy, s2);
  }
  return lp + schools_sum(s1, T(SCHOOLS) * log_scale_tau) +
         schools_sum(s2, k.sum_log_sigma);
}

// Bayesian regression at one coefficient vector beta (d values), the
// density of viabel_tpu/ops/row_models.py:55-68 at 2e6dc2c^ and
// viabel_tpu_torch/models/regression.py: mu_k = sum_j x_kj beta_j in plain
// FMA loops (no tensor cores, so no TF32), then a Gaussian or Student-t
// likelihood of scale noise_scale and an N(0, prior_std) prior, the
// scales and df by their reciprocals.  The rows sit in shared memory,
// padded (regression_row), so that a compile-time-d instance reads each
// in 16-byte words (read_words); every thread of a warp reads the same
// row, which the hardware broadcasts.  The runtime-d instance reads value
// by value.
template <typename T, int MAXD, int D_FIXED>
__device__ __forceinline__ T regression(const T (&beta)[MAXD], int d,
                                        const T* rows,
                                        const ModelArgs<T>& m) {
  T acc = T(0);  // sum of z^2 (Gaussian) or of log1p(z^2 / df) (Student-t)
  const int rs = regression_row<T>(d);
  for (int k = 0; k < m.n_rows; ++k) {
    const T* row = rows + k * rs;
    T mu = T(0), y;
    if constexpr (D_FIXED > 0) {
      T r[D_FIXED + 1];
      read_words<T, D_FIXED + 1>(row, r);
#pragma unroll
      for (int j = 0; j < D_FIXED; ++j) mu = d_fma(r[j], beta[j], mu);
      y = r[D_FIXED];
    } else {
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) mu = d_fma(row[j], beta[j], mu);
      y = row[d];
    }
    T z = (y - mu) * m.inv_noise;
    if (m.student_t)
      acc += d_log1p(z * z * m.inv_df);
    else
      acc = d_fma(z, z, acc);
  }
  T n_rows = T(m.n_rows);
  T loglik = m.student_t
                 ? n_rows * (m.lik_lognorm - m.log_noise) - m.half_df1 * acc
                 : T(-0.5) * acc - n_rows * (T(0.5 * LOG_2PI) + m.log_noise);
  T ss = T(0);
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) {
      T zb = beta[j] * m.inv_prior;
      ss = d_fma(zb, zb, ss);
    }
  }
  return loglik + (T(-0.5) * ss - T(d) * (T(0.5 * LOG_2PI) + m.log_prior));
}

// Non-centred eight-schools at one sample, the density of
// viabel_tpu/models/eight_schools.py:99-108 (d = 10, J = 8):
// theta = mu + tau * tt, an N(0, 1) prior on tt, and y ~ N(theta, sigma).
template <typename T, int MAXD>
__device__ __forceinline__ T eight_schools_ncp(const T (&x)[MAXD],
                                               const T* y,
                                               const ModelConsts<T>& k) {
  static_assert(MAXD >= 2 + SCHOOLS, "eight-schools NCP needs d = 10");
  T mu = x[0], log_tau = x[1];
  T tau = d_exp(log_tau);
  T lp = schools_prior(mu, log_tau, tau);
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int j = 0; j < SCHOOLS; ++j) {
    T tt = x[2 + j];
    s1 = d_fma(tt, tt, s1);
    T zy = (y[j] - d_fma(tau, tt, mu)) * k.inv_sigma[j];
    s2 = d_fma(zy, zy, s2);
  }
  return lp + schools_sum(s1, T(0)) + schools_sum(s2, k.sum_log_sigma);
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

// An instance of dimension MAXD compiles only the densities it can hold;
// the host refuses an eight-schools launch at any d but 10.
template <typename T, int MAXD, int D_FIXED>
__device__ __forceinline__ T model_log_density(const T (&x)[MAXD], int d,
                                               const T* s_data,
                                               const ModelArgs<T>& m,
                                               const ModelConsts<T>& k) {
  if (m.kind == REGRESSION)
    return regression<T, MAXD, D_FIXED>(x, d, s_data, m);
  if (m.kind == FUNNEL) return funnel<T, MAXD>(x, m);
  if constexpr (MAXD >= 2 + SCHOOLS) {
    if (m.kind == EIGHT_SCHOOLS_NCP)
      return eight_schools_ncp<T, MAXD>(x, s_data, k);
    return eight_schools_cp<T, MAXD>(x, s_data, k);
  }
  return T(0);
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

// Each round's two 32 x 32 -> 64-bit products are one wide multiply each.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    uint64_t p0 = uint64_t(PHILOX_M0) * c.x;
    uint64_t p1 = uint64_t(PHILOX_M1) * c.z;
    c = make_uint4(uint32_t(p1 >> 32) ^ c.y ^ k.x, uint32_t(p1),
                   uint32_t(p0 >> 32) ^ c.w ^ k.y, uint32_t(p0));
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

// Full-precision logf, sqrtf and sincosf of the rounded angle 2 pi u, the
// plain version's own steps: the normals then equal torch's to the last
// bit on this card, which the funnel's log-weights need (a 2e-6 change in
// z moves them past their tolerance; sincospi(2 u) made that change).
template <typename T>
__device__ __forceinline__ void box_muller(uint32_t b0, uint32_t b1, T& z0,
                                           T& z1) {
  T r = d_sqrt(T(-2) * d_log(uniform_from_bits<T>(b0)));
  T s, c;
  d_sincos(T(TWO_PI) * uniform_from_bits<T>(b1), &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// The 4 normals of group g, written to z[4g..4g+3] where below d; the
// second pair is computed only where the row keeps one of it.
template <typename T, int MAXD>
__device__ __forceinline__ void philox_normals(uint64_t sample,
                                               uint32_t offset, uint2 key,
                                               int d, T (&z)[MAXD]) {
#pragma unroll
  for (int g = 0; g < (MAXD + 3) / 4; ++g) {
    if (4 * g < d) {
      uint4 b = philox_group(sample, uint32_t(g), offset, key);
      T n0, n1;
      box_muller(b.x, b.y, n0, n1);
      z[4 * g] = n0;
      if (4 * g + 1 < MAXD && 4 * g + 1 < d) z[4 * g + 1] = n1;
      if (4 * g + 2 < MAXD && 4 * g + 2 < d) {
        box_muller(b.z, b.w, n0, n1);
        z[4 * g + 2] = n0;
        if (4 * g + 3 < MAXD && 4 * g + 3 < d) z[4 * g + 3] = n1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Rows of z as words, and the asynchronous copies of K1's ring.
// ---------------------------------------------------------------------------

// The widest word (up to 16 bytes) that divides a row of D values of T,
// in values: 2 for float at d = 10 (rows 40 B apart) and at d = 2, 2 for
// double at both.
template <typename T, int D>
__host__ __device__ constexpr int row_word() {
  return (D * sizeof(T)) % 16 == 0 ? int(16 / sizeof(T))
         : (D * sizeof(T)) % 8 == 0 ? int(8 / sizeof(T)) : 1;
}

// Whether a row of D values is one word, so that neighbouring threads'
// direct loads are neighbouring words (d = 2); wider rows are staged.
template <typename T, int D>
__host__ __device__ constexpr bool row_is_word() {
  return D > 0 && row_word<T, D>() == D;
}

// out[0..D) from a row whose address is a multiple of its word
template <typename T, int D, int MAXD>
__device__ __forceinline__ void read_row(const T* row, T (&out)[MAXD]) {
  constexpr int W = row_word<T, D>();
  const Pack<T, W>* words = reinterpret_cast<const Pack<T, W>*>(row);
#pragma unroll
  for (int k = 0; k < D / W; ++k) {
    Pack<T, W> word = words[k];
#pragma unroll
    for (int e = 0; e < W; ++e) out[k * W + e] = word.v[e];
  }
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* global) {
  unsigned dst = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(global)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until none of this thread's committed groups is in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Base draws of the score kernel: fill() gives z[0..d) of sample i, and
// log_density() the base log density of z summed over the d coordinates.
// ---------------------------------------------------------------------------

template <typename T, int MAXD>
__device__ __forceinline__ T normal_log_density(const T (&z)[MAXD], int d) {
  T ss = T(0);
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
    if (j < d) ss = d_fma(z[j], z[j], ss);
  return T(-0.5) * ss - T(d) * T(0.5 * LOG_2PI);
}

// K1: z read from device memory, standard normal or Student-t(df) base.
// `aligned`: z's address is a multiple of 16, so rows may be read as words
// and sub-tiles copied 16 bytes at a time; else every load is one value.
template <typename T>
struct LoadedDraws {
  const T* z;
  int student_t, aligned;
  T inv_df, half_df1, t_lognorm;

  // wide rows of a compile-time d come through the shared-memory ring
  template <int D_FIXED>
  __host__ __device__ static constexpr bool staged() {
    return D_FIXED > 0 && !row_is_word<T, D_FIXED>();
  }

  template <int MAXD, int D_FIXED>
  __device__ __forceinline__ void fill(int64_t i, int d, T (&out)[MAXD]) const {
    const T* row = z + i * d;
    if constexpr (row_is_word<T, D_FIXED>()) {
      if (aligned) {
        read_row<T, D_FIXED, MAXD>(row, out);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) out[j] = __ldg(row + j);
  }

  // Student-t: sum_j log1p(z_j^2 / df) as the logarithm of the product of
  // two neighbours' 1 + z^2 / df, half the logarithms; the product
  // overflows float only beyond |z| = 1e10.
  template <int MAXD>
  __device__ __forceinline__ T log_density(const T (&zz)[MAXD], int d) const {
    static_assert(MAXD % 2 == 0, "coordinates are taken in pairs");
    if (!student_t) return normal_log_density<T, MAXD>(zz, d);
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < MAXD; j += 2) {
      if (j < d) {
        T a = d_fma(zz[j] * zz[j], inv_df, T(1));
        T b = j + 1 < d ? d_fma(zz[j + 1] * zz[j + 1], inv_df, T(1)) : T(1);
        acc += d_log(a * b);
      }
    }
    return T(d) * t_lognorm - half_df1 * acc;
  }
};

// K2: standard normal z made in registers from the Philox stream; the
// launch's sample i is sample start + i of the stream, so a launch may
// score any row range of it
template <typename T>
struct PhiloxDraws {
  uint2 key;
  uint32_t offset;
  uint64_t start;

  template <int D_FIXED>
  __host__ __device__ static constexpr bool staged() {
    return false;
  }

  template <int MAXD, int D_FIXED>
  __device__ __forceinline__ void fill(int64_t i, int d, T (&out)[MAXD]) const {
    philox_normals<T, MAXD>(start + uint64_t(i), offset, key, d, out);
  }

  template <int MAXD>
  __device__ __forceinline__ T log_density(const T (&zz)[MAXD], int d) const {
    return normal_log_density<T, MAXD>(zz, d);
  }
};

// Dynamic shared memory of the score kernel: the ring (a staged instance
// only), then mean and exp(log_scale) (MAXD each), then the model's staged
// data (ModelArgs::staged_values), 16-byte aligned.
template <typename T, int MAXD, bool STAGED>
__host__ __device__ constexpr size_t ring_bytes() {
  return STAGED ? sizeof(T) * STAGES * THREADS * MAXD : 0;
}
template <typename T, int MAXD, bool STAGED>
inline size_t score_smem_bytes(const ModelArgs<T>& m, int d) {
  static_assert(2 * MAXD * sizeof(T) % 16 == 0, "staged rows start aligned");
  return ring_bytes<T, MAXD, STAGED>() +
         sizeof(T) * (2 * MAXD + m.staged_values(d));
}

// Copy this warp's 32 rows of sub-tile k (THREADS rows of D values) of
// chunk c into their ring slot, 16 bytes a lane and a step, if the chunk
// exists and the sub-tile is whole; a ragged one is read directly.  A warp
// copies what its own lanes will read, so a warp barrier orders the ring
// and no block barrier is needed.  Always commits a group, so that every
// thread counts the same groups.
template <typename T, int D>
__device__ __forceinline__ void issue_sub_tile(const T* z, T* ring,
                                               int64_t c, int k,
                                               int64_t n, int64_t n_chunks) {
  constexpr int WORDS = 32 * D * int(sizeof(T)) / 16;
  const int lane = threadIdx.x & 31, warp_row = threadIdx.x & ~31;
  int64_t first = c * CHUNK + int64_t(k) * THREADS;
  if (c < n_chunks && first + THREADS <= n) {
    const char* src =
        reinterpret_cast<const char*>(z + (first + warp_row) * D);
    char* dst = reinterpret_cast<char*>(
        ring + ((k % STAGES) * THREADS + warp_row) * D);
    for (int w = lane; w < WORDS; w += 32)
      cp_async_16(dst + 16 * w, src + 16 * w);
  }
  cp_async_commit();
}

// The score kernel of K1 and K2: x = mean + exp(log_scale) z,
// lw = log p(x) - log q(x) with log q = base log density of z minus
// sum(log_scale); lw is written and reduced to one partials row per chunk.
// One thread per sample (ITEMS samples a thread, THREADS apart), the
// blocks that the card holds at once striding over the chunks.  With
// D_FIXED > 0 the dimension is that compile-time constant and every
// `j < d` guard folds away; with D_FIXED = 0 it is the runtime
// d_arg <= MAXD.  A staged instance (K1 at d = 10) keeps one
// sub-tile of z in flight, across chunk boundaries too: for sub-tile k a warp
// waits for its own copies, one warp barrier makes them visible and frees
// the slot scored last, which the next copy then takes.
template <typename T, int MAXD, int D_FIXED, class Draws>
__global__ void __launch_bounds__(
    THREADS, D_FIXED > 0 ? MIN_BLOCKS_FIXED_D : MIN_BLOCKS_RUNTIME_D)
    score_partials_kernel(Draws draws, const T* __restrict__ mean,
                          const T* __restrict__ log_scale, int d_arg,
                          ModelArgs<T> model, int64_t n, int64_t n_chunks,
                          T alpha, T* __restrict__ lw,
                          T* __restrict__ partials) {
  constexpr bool STAGED = Draws::template staged<D_FIXED>();
  const int d = D_FIXED > 0 ? D_FIXED : d_arg;
  __shared__ WarpStats<T> sh;
  __shared__ ModelConsts<T> consts;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* s_mean = reinterpret_cast<T*>(smem_raw + ring_bytes<T, MAXD, STAGED>());
  T* s_scale = s_mean + MAXD;
  T* s_data = s_scale + MAXD;

  bool use_ring = false;
  if constexpr (STAGED) {
    use_ring = draws.aligned != 0;
    if (use_ring)
      issue_sub_tile<T, D_FIXED>(draws.z, ring, blockIdx.x, 0, n, n_chunks);
  }

  for (int j = threadIdx.x; j < MAXD; j += THREADS) {
    s_mean[j] = j < d ? mean[j] : T(0);
    s_scale[j] = j < d ? d_exp(log_scale[j]) : T(0);
  }
  const int rs = regression_row<T>(d);
  for (int j = threadIdx.x; j < model.staged_values(d); j += THREADS) {
    if (model.kind == REGRESSION) {  // row k: x_k, y_k, zeros
      int k = j / rs, c = j - k * rs;
      s_data[j] = c < d ? model.a[k * d + c] : c == d ? model.b[k] : T(0);
    } else {
      s_data[j] = model.a[j];
    }
  }
  T sum_log_scale = T(0);
  for (int j = 0; j < d; ++j) sum_log_scale += log_scale[j];
  if (model.schools() && threadIdx.x < SCHOOLS) {
    T sigma = model.b[threadIdx.x];
    consts.inv_sigma[threadIdx.x] = T(1) / sigma;
    // the eight logarithms, summed in order by the warp's first lane
    T log_sigma = d_log(sigma);
    T total = T(0);
#pragma unroll
    for (int j = 0; j < SCHOOLS; ++j)
      total += __shfl_sync((1u << SCHOOLS) - 1u, log_sigma, j);
    if (threadIdx.x == 0) consts.sum_log_sigma = total;
  }
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
      T x[MAXD];
      bool have_row = false;
      if constexpr (STAGED) {
        if (use_ring) {
          cp_async_wait();
          __syncwarp();
          issue_sub_tile<T, D_FIXED>(
              draws.z, ring, k + 1 < ITEMS ? c : c + gridDim.x,
              (k + 1) % ITEMS, n, n_chunks);
          if (base + int64_t(k + 1) * THREADS <= n) {  // a whole sub-tile
            read_row<T, D_FIXED, MAXD>(
                ring + ((k % STAGES) * THREADS + threadIdx.x) * D_FIXED, x);
            have_row = true;
          }
        }
      }
      if (!ok[k]) continue;
      if (!have_row) draws.template fill<MAXD, D_FIXED>(i, d, x);
      T logq = draws.template log_density<MAXD>(x, d) - sum_log_scale;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) x[j] = s_mean[j] + s_scale[j] * x[j];
      v[k] = model_log_density<T, MAXD, D_FIXED>(x, d, s_data, model,
                                                 consts) - logq;
      lw[i] = v[k];
    }
    chunk_partials(v, ok, base, n, alpha, sh, partials + c * NPART);
  }
}

inline int64_t chunks_of(int64_t n) { return (n + CHUNK - 1) / CHUNK; }

// The blocks of `kernel` that the current device holds at once, at
// `threads` a block and `smem` bytes of dynamic shared memory; 0 and the
// error in *err if CUDA refuses.
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem,
                    cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
  return *err == cudaSuccess ? sms * per_sm : 0;
}

// Launch one instance of the score kernel.  The instance is allowed its
// largest dynamic shared memory once a device, not at every launch.
template <typename T, int MAXD, int D_FIXED, class Draws>
int launch_score_at(const Draws& draws, const void* mean,
                    const void* log_scale, int d, const ModelSpec* spec,
                    long long n, double alpha, void* lw, void* partials,
                    void* stream) {
  constexpr bool STAGED = Draws::template staged<D_FIXED>();
  constexpr size_t MAX_SMEM = ring_bytes<T, MAXD, STAGED>() +
                              sizeof(T) * 2 * MAXD + MAX_STAGED_BYTES;
  static bool allowed[MAX_DEVICES] = {};
  ModelArgs<T> model(*spec);
  if (model.schools() && (d != 2 + SCHOOLS || model.n_rows != SCHOOLS))
    return int(cudaErrorInvalidValue);
  size_t smem = score_smem_bytes<T, MAXD, STAGED>(model, d);
  if (smem > MAX_SMEM) return int(cudaErrorInvalidValue);
  auto kernel = score_partials_kernel<T, MAXD, D_FIXED, Draws>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(MAX_SMEM));
    if (err != cudaSuccess) return int(err);
    allowed[dev] = true;
  }
  int resident = resident_blocks(kernel, THREADS, smem, &err);
  if (err != cudaSuccess) return int(err);
  if (resident < 1) return int(cudaErrorLaunchOutOfResources);
  int64_t nc = chunks_of(n);
  int grid = int(nc < resident ? nc : resident);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      draws, static_cast<const T*>(mean), static_cast<const T*>(log_scale), d,
      model, n, nc, T(alpha), static_cast<T*>(lw), static_cast<T*>(partials));
  return int(cudaGetLastError());
}

// d = 10 (eight-schools CP and NCP, the regression path's D) and d = 2
// (the funnel, the robust regression) run compile-time instances; any
// other d the runtime instance of MAX_DIM, with direct loads.
template <typename T, class Draws>
int launch_score(const Draws& draws, const void* mean, const void* log_scale,
                 int d, const ModelSpec* spec, long long n, double alpha,
                 void* lw, void* partials, void* stream) {
  if (d < 1 || d > MAX_DIM || n < 1) return int(cudaErrorInvalidValue);
  if (d == 10)
    return launch_score_at<T, 10, 10>(draws, mean, log_scale, d, spec, n,
                                      alpha, lw, partials, stream);
  if (d == 2)
    return launch_score_at<T, 2, 2>(draws, mean, log_scale, d, spec, n, alpha,
                                    lw, partials, stream);
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
int bound_pass_max_staged_bytes(void) { return bound_pass::MAX_STAGED_BYTES; }
int bound_pass_model_spec_size(void) {
  return int(sizeof(bound_pass::ModelSpec));
}
}  // extern "C"
