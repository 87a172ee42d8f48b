// Log-weight kernels of the validated-VI bound pass, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes; the Python wrappers live in
// viabel_tpu_torch/ops/lw_stats.py beside their plain PyTorch versions.
// The statistics, the model densities and the score kernel are shared with
// K2 (gaussian_lw.cu) through bound_pass.cuh.
//
// Kernels (each a template over float and double):
//
// * transform_score_partials (K1) replaces the TPU kernel
//   fused_location_scale_lw_stats (viabel_tpu/ops/sample_score.py:333-385
//   at 2e6dc2c^): x = mean + exp(log_scale) * z, lw = log p(x) - log q(x)
//   with log q from the base density of z, then per-chunk partial
//   statistics of lw.  z is (n, d) with d <= 32; the model density is
//   eight-schools CP or NCP, the funnel or the regression density
//   (bound_pass.cuh).
// * lw_partials (K3) replaces streaming_lw_stats
//   (viabel_tpu/ops/sample_score.py:108-142 at 2e6dc2c^): the same
//   per-chunk partials over an existing lw vector.
// * combine_partials replaces the _combine_tiles epilogue
//   (viabel_tpu/ops/sample_score.py:67-91 at 2e6dc2c^).
//
// What bounds them on an H100 (PERF.md has the times).  K1 reads 4 d + 4
// bytes a sample and spends several hundred instructions on it (the
// exponentials and logarithms of the density and of the Student-t base in
// full precision), so it is bound by the rate at which the SMs issue
// instructions before device memory: at d = 10 it takes 2.3-2.5x the time
// its bytes alone would (NVIDIA H100 80GB HBM3 at 700 W), and on the
// regression density the 2 N d operations of x beta dominate.  Its design
// therefore cuts instructions first (constants of the launch computed
// once, half the logarithms, statistics by shuffles without divisions) and
// then makes each load whole: z at d = 10 comes through a shared-memory
// ring of cp.async copies, d = 2 reads one word a row, and the grid is what
// the card holds at once (bound_pass.cuh).  K3 moves 4 bytes a sample, is
// bound by bytes and shares K1's shuffle statistics.  combine_partials
// reads a few KB in one block; its time is launch latency.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

constexpr int COMBINE_THREADS = 512;

// K3: the same partials over an existing lw vector.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    lw_partials_kernel(const T* __restrict__ lw, int64_t n, int64_t n_chunks,
                       T alpha, T* __restrict__ partials) {
  __shared__ WarpStats<T> sh;
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
    chunk_partials(v, ok, base, n, alpha, sh, partials + c * NPART);
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

template <typename T>
int launch_transform_score(const void* z, const void* mean,
                           const void* log_scale, long long n, int d,
                           int base_kind, double df, double t_lognorm,
                           double alpha, const ModelSpec* spec, void* lw,
                           void* partials, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(z) % 16 == 0;
  LoadedDraws<T> draws{static_cast<const T*>(z),
                       base_kind,
                       int(aligned),
                       T(base_kind ? 1.0 / df : 0.0),
                       T(0.5 * (df + 1.0)),
                       T(t_lognorm)};
  return launch_score<T>(draws, mean, log_scale, d, spec, n, alpha, lw,
                         partials, stream);
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

int transform_score_partials_f32(const void* z, const void* mean,
                                 const void* log_scale, long long n, int d,
                                 int base_kind, double df, double t_lognorm,
                                 double alpha, const ModelSpec* spec, void* lw,
                                 void* partials, void* stream) {
  return launch_transform_score<float>(z, mean, log_scale, n, d, base_kind, df,
                                       t_lognorm, alpha, spec, lw, partials,
                                       stream);
}

int transform_score_partials_f64(const void* z, const void* mean,
                                 const void* log_scale, long long n, int d,
                                 int base_kind, double df, double t_lognorm,
                                 double alpha, const ModelSpec* spec, void* lw,
                                 void* partials, void* stream) {
  return launch_transform_score<double>(z, mean, log_scale, n, d, base_kind,
                                        df, t_lognorm, alpha, spec, lw,
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
