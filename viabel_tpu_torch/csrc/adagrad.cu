// The windowed-adagrad step, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes; the Python wrapper lives in
// viabel_tpu_torch/ops/adagrad.py beside its plain PyTorch version.
//
// adagrad_step (a template over float and double) is one iteration of the
// JAX package's windowed adagrad, the body of its compiled lax.scan:
// _make_adagrad_step (viabel_tpu/optimizers.py:201-230) with its window
// _window_accum (:149-165) and the tail sum of _adagrad_run (:269-275),
// for each of K runs at once: the K rows of the JAX package's vmapped scan
// (validated_vi_multistart and validated_vi_sweep,
// viabel_tpu/pipeline.py:560-836).  A single run is the case K = 1.
// It is no port of a Pallas kernel (there was none): it is how the port
// gets the JAX package's single compiled loop, together with the CUDA graph
// that optimizers._adagrad_run replays over the objective and this step.
//
// Run k's state is row k of each array: param, the ring's gradients
// (window, P) and log-norms (window,), its int64 counter, its
// learning-rate table (n_iters,), values, log-norms, the history
// (n_iters, P) and the tail sum.  The iteration i of run k is read from
// run k's counter on the device, so the launch is the same at every
// iteration and can be replayed from a graph:
//   1. grad and log_norm go to ring slot i % window;
//   2. the min of the log-norms over the min(i + 1, window) filled slots
//      (NaN propagates, as jnp.min); unfilled slots have scale 0;
//   3. accum = sum over the filled slots of (exp(min - ln_s) g_s)^2;
//   4. lr = lr_table[i], the schedule cast to T on the host;
//   5. param -= lr g / sqrt(eps + accum), in place;
//   6. values[i], log_norms[i] and, with a history, params[i] are written;
//   7. param is added to tail_sum when i >= tail_start;
//   8. the counter advances.
//
// One block a run, a thread a coordinate (a P above the block's threads
// loops), and each run has its own counter slot.  The block takes each
// filled slot's scale exp(min - ln_s) once, into shared memory, and every
// coordinate multiplies by it (the same product as an exp a coordinate).  A single counter shared
// by the K blocks would race: the block that advanced it first would let
// a slower block read iteration i + 1.  With a slot a run, only block k
// reads or writes counter k, and one barrier orders every thread's reads
// of the ring's log-norms and of the counter before thread 0 writes them.
// The runs always stand at the same iteration (every launch advances each
// counter by one), so the caller may read any slot for the iteration.
//
// What bounds it on an H100: at small P nothing of its work.  It moves
// (3 window + 7) P values and does ~5 window P operations a run, about
// 1.4 KB and 1e3 operations at P = 20 (PERF.md), so it takes the few
// microseconds of any launch.  What it replaces is the ~17 small launches
// of the eager step and the host's decisions between them (slot, fill,
// learning rate, tail), which kept the optimizer loop from being captured.
// At P = 5150 (a full-rank d = 100 family) one block's 256 threads loop
// over ~21 coordinates each: one SM does the run (PERF.md times it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

// min that propagates NaN, as jnp.min and torch.min do
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    adagrad_step_kernel(const T* __restrict__ grad,
                        const T* __restrict__ value,
                        const T* __restrict__ log_norm,
                        const T* __restrict__ lr_table,
                        int64_t* __restrict__ counter, T* __restrict__ param,
                        T* __restrict__ ring_grads, T* __restrict__ ring_ln,
                        T* __restrict__ values, T* __restrict__ log_norms,
                        T* __restrict__ params, T* __restrict__ tail_sum,
                        int P, int window, int64_t n_iters,
                        int64_t tail_start, T eps) {
  extern __shared__ unsigned char smem[];
  T* scale = reinterpret_cast<T*>(smem);  // window values
  // run k's rows, indexed from the restrict-qualified arguments themselves
  const int64_t k = blockIdx.x;
  const int64_t kP = k * P, kw = k * window, kn = k * n_iters;
  const int64_t i = counter[k];
  // the drivers never step past the run; a counter out of range writes
  // nothing, and the driver's final check of the counter reports it
  if (i < 0 || i >= n_iters) return;
  const int slot = int(i % window);
  const int filled = i + 1 < window ? int(i + 1) : window;
  const T ln = log_norm[k];
  T mn = T(INFINITY);
  for (int s = 0; s < filled; ++s)
    mn = nan_min(mn, s == slot ? ln : ring_ln[kw + s]);
  // each filled slot's scale exp(min - ln_s), once a block
  for (int s = threadIdx.x; s < filled; s += blockDim.x)
    scale[s] = d_exp(mn - (s == slot ? ln : ring_ln[kw + s]));
  __syncthreads();
  const T lr = lr_table[kn + i];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const T g = grad[kP + p];
    T accum = T(0);
    for (int s = 0; s < filled; ++s) {
      const T gs = s == slot ? g : ring_grads[(kw + s) * P + p];
      const T t = scale[s] * gs;
      accum += t * t;
    }
    ring_grads[(kw + slot) * P + p] = g;  // a thread's own column
    const T x = param[kP + p] - lr * g / d_sqrt(eps + accum);
    param[kP + p] = x;
    if (params != nullptr) params[(kn + i) * P + p] = x;
    if (i >= tail_start) tail_sum[kP + p] += x;
  }
  __syncthreads();  // every thread has read the ring's log-norms and i
  if (threadIdx.x == 0) {
    ring_ln[kw + slot] = ln;
    values[kn + i] = value[k];
    log_norms[kn + i] = ln;
    counter[k] = i + 1;
  }
}

template <typename T>
int launch_step(const void* grad, const void* value, const void* log_norm,
                const void* lr_table, void* counter, void* param,
                void* ring_grads, void* ring_ln, void* values,
                void* log_norms, void* params, void* tail_sum, int K, int P,
                int window, long long n_iters, long long tail_start,
                double eps, void* stream) {
  const size_t smem = size_t(window) * sizeof(T);
  if (K < 1 || P < 1 || window < 1 || n_iters < 1 || smem > 48 * 1024)
    return int(cudaErrorInvalidValue);
  const int threads = P < MAX_THREADS ? (P + 31) / 32 * 32 : MAX_THREADS;
  adagrad_step_kernel<T>
      <<<K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(grad), static_cast<const T*>(value),
          static_cast<const T*>(log_norm), static_cast<const T*>(lr_table),
          static_cast<int64_t*>(counter), static_cast<T*>(param),
          static_cast<T*>(ring_grads), static_cast<T*>(ring_ln),
          static_cast<T*>(values), static_cast<T*>(log_norms),
          static_cast<T*>(params), static_cast<T*>(tail_sum), P, window,
          n_iters, tail_start, T(eps));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int adagrad_step_f32(const void* grad, const void* value,
                     const void* log_norm, const void* lr_table,
                     void* counter, void* param, void* ring_grads,
                     void* ring_ln, void* values, void* log_norms,
                     void* params, void* tail_sum, int K, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     void* stream) {
  return launch_step<float>(grad, value, log_norm, lr_table, counter, param,
                            ring_grads, ring_ln, values, log_norms, params,
                            tail_sum, K, P, window, n_iters, tail_start, eps,
                            stream);
}

int adagrad_step_f64(const void* grad, const void* value,
                     const void* log_norm, const void* lr_table,
                     void* counter, void* param, void* ring_grads,
                     void* ring_ln, void* values, void* log_norms,
                     void* params, void* tail_sum, int K, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     void* stream) {
  return launch_step<double>(grad, value, log_norm, lr_table, counter, param,
                             ring_grads, ring_ln, values, log_norms, params,
                             tail_sum, K, P, window, n_iters, tail_start, eps,
                             stream);
}

}  // extern "C"
