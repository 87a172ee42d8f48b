// The mean-field-Gaussian bound pass with its draws made in-kernel, for
// Hopper (sm_90a), and the Philox normal stream it draws from.
//
// Built by viabel_tpu_torch/ops/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, plain C interface, ctypes); the Python
// wrappers and their plain PyTorch versions live in
// viabel_tpu_torch/ops/gaussian_lw.py and ops/philox.py.
//
// Kernels (each a template over float and double):
//
// * gaussian_sample_score_partials (K2) replaces the TPU kernel
//   fused_gaussian_lw_stats (viabel_tpu/ops/sample_score.py:223-282,
//   _fused_kernel :193-220, its PRNG :152-168, at 2e6dc2c^).  Each sample's
//   d standard normals come from the Philox4x32-10 stream of (seed, offset)
//   in registers (bound_pass.cuh); then x = mean + exp(log_std) z,
//   log q = -0.5 sum(z^2 + log 2 pi) - sum(log_std), log p(x) from the
//   model's device function, lw written, and one partials row per chunk
//   in K1's layout, which combine_partials (lw_stats.cu) reduces.  The TPU
//   kernel seeded its own generator per grid step; here the counter names
//   the sample, so the draws do not depend on the launch's shape, and
//   philox_normal reproduces them.  No sample array reaches device memory.
// * philox_normal writes the same z (n, d) of the same stream, for the
//   callers that need the samples (PSIS, get_samples_and_log_weights).
// * philox_bits runs the bare generator on given counters; it is the
//   device half of the known-answer and bit-equality checks, and is on no
//   path.
//
// What bounds them on an H100.  K2 writes 4 B of lw a sample and reads
// nothing per sample, so it is bound by operations: ~130 a normal group of
// 4 (Philox's 10 rounds, the uniforms, two Box-Muller pairs), the
// transform and log q (~5 a coordinate), and the model density, which at
// the regression's N = 100, d = 10 is ~2600 (the mu loop alone is 2 N d).
// philox_normal is bound by its bytes, n d 4 B written in f32: each thread
// writes one group's 16 contiguous bytes beside its neighbours'.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

constexpr int NORMAL_THREADS = 256;
constexpr int NORMAL_MAX_GRID = 132 * 16;

// One thread per (sample, group of 4 normals), neighbours on neighbouring
// groups.
template <typename T>
__global__ void __launch_bounds__(NORMAL_THREADS)
    philox_normal_kernel(int64_t n, int d, uint64_t start, uint2 key,
                         uint32_t offset, T* __restrict__ z) {
  int groups = (d + 3) / 4;
  int64_t total = n * groups;
  for (int64_t t = int64_t(blockIdx.x) * NORMAL_THREADS + threadIdx.x;
       t < total; t += int64_t(gridDim.x) * NORMAL_THREADS) {
    int64_t s = t / groups;
    int g = int(t - s * groups);
    uint4 b = philox_group(start + uint64_t(s), uint32_t(g), offset, key);
    T v[4];
    box_muller(b.x, b.y, v[0], v[1]);
    box_muller(b.z, b.w, v[2], v[3]);
    T* row = z + s * d + 4 * g;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * g + q < d) row[q] = v[q];
  }
}

__global__ void philox_bits_kernel(const uint32_t* __restrict__ counters,
                                   int64_t n, uint2 key,
                                   uint32_t* __restrict__ out) {
  for (int64_t i = int64_t(blockIdx.x) * NORMAL_THREADS + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * NORMAL_THREADS) {
    const uint32_t* c = counters + 4 * i;
    uint4 r = philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]), key);
    out[4 * i] = r.x;
    out[4 * i + 1] = r.y;
    out[4 * i + 2] = r.z;
    out[4 * i + 3] = r.w;
  }
}

uint2 key_of(unsigned long long seed) {
  return make_uint2(uint32_t(seed), uint32_t(seed >> 32));
}

int grid_for(int64_t work) {
  int64_t blocks = (work + NORMAL_THREADS - 1) / NORMAL_THREADS;
  return int(blocks < NORMAL_MAX_GRID ? (blocks > 0 ? blocks : 1)
                                      : NORMAL_MAX_GRID);
}

template <typename T>
int launch_gaussian_score(const void* mean, const void* log_std, long long n,
                          int d, unsigned long long seed, unsigned int offset,
                          double alpha, const ModelSpec* spec, void* lw,
                          void* partials, void* stream) {
  PhiloxDraws<T> draws{key_of(seed), offset};
  return launch_score<T>(draws, mean, log_std, d, spec, n, alpha, lw,
                         partials, stream);
}

template <typename T>
int launch_philox_normal(long long n, int d, unsigned long long start,
                         unsigned long long seed, unsigned int offset, void* z,
                         void* stream) {
  int64_t work = int64_t(n) * ((d + 3) / 4);
  philox_normal_kernel<T><<<grid_for(work), NORMAL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, d, start, key_of(seed), offset, static_cast<T*>(z));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int gaussian_sample_score_partials_f32(const void* mean, const void* log_std,
                                       long long n, int d,
                                       unsigned long long seed,
                                       unsigned int offset, double alpha,
                                       const ModelSpec* spec, void* lw,
                                       void* partials, void* stream) {
  return launch_gaussian_score<float>(mean, log_std, n, d, seed, offset, alpha,
                                      spec, lw, partials, stream);
}

int gaussian_sample_score_partials_f64(const void* mean, const void* log_std,
                                       long long n, int d,
                                       unsigned long long seed,
                                       unsigned int offset, double alpha,
                                       const ModelSpec* spec, void* lw,
                                       void* partials, void* stream) {
  return launch_gaussian_score<double>(mean, log_std, n, d, seed, offset,
                                       alpha, spec, lw, partials, stream);
}

int philox_normal_f32(long long n, int d, unsigned long long start,
                      unsigned long long seed, unsigned int offset, void* z,
                      void* stream) {
  return launch_philox_normal<float>(n, d, start, seed, offset, z, stream);
}

int philox_normal_f64(long long n, int d, unsigned long long start,
                      unsigned long long seed, unsigned int offset, void* z,
                      void* stream) {
  return launch_philox_normal<double>(n, d, start, seed, offset, z, stream);
}

int philox_bits(const void* counters, long long n, unsigned long long seed,
                void* out, void* stream) {
  philox_bits_kernel<<<grid_for(n), NORMAL_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), n, key_of(seed),
      static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
