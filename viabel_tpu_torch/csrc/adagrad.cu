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
// _window_accum (:149-165) and the tail sum of _adagrad_run (:269-275).
// It is no port of a Pallas kernel (there was none): it is how the port
// gets the JAX package's single compiled loop, together with the CUDA graph
// that optimizers._adagrad_run replays over the objective and this step.
//
// The iteration i is read from an int64 counter on the device, so the
// launch is the same at every iteration and can be replayed from a graph:
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
// What bounds it on an H100: nothing of its work.  It moves (3 window + 7)
// P values and does ~5 window P operations, about 1.4 KB and 1e3
// operations at P = 20 (PERF.md), so it takes the few microseconds of any
// launch.  What it replaces is the ~17 small launches of the eager step
// and the host's decisions between them (slot, fill, learning rate, tail),
// which kept the optimizer loop from being captured.  One block does the
// whole step, a thread a coordinate: the block reads the counter, and one
// barrier orders every thread's reads of the ring's log-norms and of the
// counter before thread 0 writes them, so no two blocks can race on the
// counter or the new slot.  A P above the block's threads loops.

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
  const int64_t i = *counter;
  // the drivers never step past the run; a counter out of range writes
  // nothing, and the driver's final check of the counter reports it
  if (i < 0 || i >= n_iters) return;
  const int slot = int(i % window);
  const int filled = i + 1 < window ? int(i + 1) : window;
  const T ln = *log_norm;
  T mn = T(INFINITY);
  for (int s = 0; s < filled; ++s)
    mn = nan_min(mn, s == slot ? ln : ring_ln[s]);
  const T lr = lr_table[i];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const T g = grad[p];
    T accum = T(0);
    for (int s = 0; s < filled; ++s) {
      const T gs = s == slot ? g : ring_grads[int64_t(s) * P + p];
      const T t = d_exp(mn - (s == slot ? ln : ring_ln[s])) * gs;
      accum += t * t;
    }
    ring_grads[int64_t(slot) * P + p] = g;  // a thread's own column
    const T x = param[p] - lr * g / d_sqrt(eps + accum);
    param[p] = x;
    if (params != nullptr) params[i * P + p] = x;
    if (i >= tail_start) tail_sum[p] += x;
  }
  __syncthreads();  // every thread has read the ring's log-norms and i
  if (threadIdx.x == 0) {
    ring_ln[slot] = ln;
    values[i] = *value;
    log_norms[i] = ln;
    *counter = i + 1;
  }
}

template <typename T>
int launch_step(const void* grad, const void* value, const void* log_norm,
                const void* lr_table, void* counter, void* param,
                void* ring_grads, void* ring_ln, void* values,
                void* log_norms, void* params, void* tail_sum, int P,
                int window, long long n_iters, long long tail_start,
                double eps, void* stream) {
  if (P < 1 || window < 1 || n_iters < 1) return int(cudaErrorInvalidValue);
  const int threads = P < MAX_THREADS ? (P + 31) / 32 * 32 : MAX_THREADS;
  adagrad_step_kernel<T>
      <<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
                     void* params, void* tail_sum, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     void* stream) {
  return launch_step<float>(grad, value, log_norm, lr_table, counter, param,
                            ring_grads, ring_ln, values, log_norms, params,
                            tail_sum, P, window, n_iters, tail_start, eps,
                            stream);
}

int adagrad_step_f64(const void* grad, const void* value,
                     const void* log_norm, const void* lr_table,
                     void* counter, void* param, void* ring_grads,
                     void* ring_ln, void* values, void* log_norms,
                     void* params, void* tail_sum, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     void* stream) {
  return launch_step<double>(grad, value, log_norm, lr_table, counter, param,
                             ring_grads, ring_ln, values, log_norms, params,
                             tail_sum, P, window, n_iters, tail_start, eps,
                             stream);
}

}  // extern "C"
