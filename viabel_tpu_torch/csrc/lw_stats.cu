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
//   (viabel_tpu/ops/sample_score.py:67-91 at 2e6dc2c^): one block reduces
//   the partials rows to the five statistics (combine_rows).
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
// the card holds at once (bound_pass.cuh).  K3 moves 4 bytes a sample and
// shares K1's shuffle statistics; its note below says what holds it.  The combine reads a
// few KB: one block cannot approach its bytes bound, and its time is a
// chain of dependent steps, so it takes shuffles and a single barrier a
// step.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

// K3: the same partials over an existing lw vector.  It moves 4 (f32) or
// 8 (f64) bytes a sample, so its bound is device memory's: 10 MB, 0.0030
// ms at 2.5e6 f32 samples.  It takes three times that (PERF.md).  A block
// of 256 threads takes a chunk with K1's shuffle statistics
// (chunk_partials); a thread reads its 8 values as 16-byte words (2
// float4 or 4 double2, neighbouring threads on neighbouring words); the
// grid is the blocks the card holds at once, each walking chunks in a
// stride.  A misaligned lw, and the ragged last chunk, are read value by
// value in the same order.  This took the parent's time, and three other
// designs were no faster (PERF.md): the next chunk's loads issued before
// the current one's reduction, two chunks a block; a warp a chunk, 64
// values a lane, no barrier; 128 threads a chunk, 16 values a thread,
// every chunk of the paths resident at once.  So neither the loads' width
// nor the waves nor the reductions' instruction count bounds it; left is
// the latency of a chunk's chain of dependent steps (loads, max, barrier,
// exponentials, merges, barrier), unconfirmed.
template <typename T>
constexpr int VEC = 16 / int(sizeof(T));  // values in a 16-byte word

// the offset in its chunk of a thread's k-th value: word k / VEC of the
// thread's words, which lie THREADS words apart, value k % VEC in it
template <typename T>
__device__ __forceinline__ int k3_offset(int k) {
  return ((k / VEC<T>)*THREADS + int(threadIdx.x)) * VEC<T> + k % VEC<T>;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lw_partials_kernel(const T* __restrict__ lw, int64_t n, int64_t n_chunks,
                       int aligned, T alpha, T* __restrict__ partials) {
  __shared__ WarpStats<T> sh;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t base = c * CHUNK;
    T v[ITEMS];
    bool ok[ITEMS];
    if (aligned && base + CHUNK <= n) {
      const Pack<T, VEC<T>>* w =
          reinterpret_cast<const Pack<T, VEC<T>>*>(lw + base);
#pragma unroll
      for (int u = 0; u < ITEMS / VEC<T>; ++u) {
        const Pack<T, VEC<T>> p = w[u * THREADS + threadIdx.x];
#pragma unroll
        for (int j = 0; j < VEC<T>; ++j) v[u * VEC<T> + j] = p.v[j];
      }
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int64_t i = base + k3_offset<T>(k);
        v[k] = i < n ? lw[i] : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) ok[k] = base + k3_offset<T>(k) < n;
    chunk_partials(v, ok, base, n, alpha, sh, partials + c * NPART);
  }
}

// The combine on its own: combine_rows in one block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_partials_kernel(const T* __restrict__ partials, int64_t n_chunks,
                            T alpha, T* __restrict__ out) {
  __shared__ WarpStats<T> sh;
  combine_rows(partials, n_chunks, alpha, sh, out);
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

// K3's grid: a block a chunk, or the blocks the card holds at once.
template <typename T>
int launch_lw_partials(const void* lw, long long n, double alpha,
                       void* partials, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(lw_partials_kernel<T>, THREADS, 0,
                                       &err);
  if (err != cudaSuccess) return int(err);
  if (resident < 1) return int(cudaErrorLaunchOutOfResources);
  const int64_t nc = chunks_of(n);
  const int grid = int(nc < resident ? nc : resident);
  const int aligned = reinterpret_cast<uintptr_t>(lw) % 16 == 0;
  lw_partials_kernel<T>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(lw), n, nc, aligned, T(alpha),
          static_cast<T*>(partials));
  return int(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* partials, long long n_chunks, double alpha,
                   void* out, void* stream) {
  if (n_chunks < 1) return int(cudaErrorInvalidValue);
  combine_partials_kernel<T>
      <<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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
