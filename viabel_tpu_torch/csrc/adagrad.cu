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
//   1. grad and log_norm go to ring slot i % window (an objective without
//      a log-norm passes none, and 0 is written);
//   2. the min of the log-norms over the min(i + 1, window) filled slots
//      (NaN propagates, as jnp.min); unfilled slots have scale 0;
//   3. accum = sum over the filled slots, in slot order, of
//      (exp(min - ln_s) g_s)^2;
//   4. lr = lr_table[i], the schedule cast to T on the host;
//   5. param -= lr g / sqrt(eps + accum), in place;
//   6. values[i], log_norms[i] and, with a history, params[i] are written;
//   7. param is added to tail_sum when i >= tail_start;
//   8. the counter advances.
//
// What bounds it on an H100.  Its bytes are few: (window + 7) P values a
// run, 1.4 KB at P = 20 and 2.5 MB at P = 45450 (a full-rank d = 300
// family), under a microsecond of memory time either way.  What it waits
// for is latency: at small P each dependent trip to memory, at large P the
// few SMs that one block a run would use.  The design, and the shape of a
// launch that ops/adagrad.launch_shape picks from (K, P, window, dtype):
//   * Every load that does not depend on the iteration is issued first, at
//     once: the counter, the log-norm, the value, the ring's log-norms (a
//     lane a slot) and each thread's first column (grad, param, tail sum
//     and, in the window-10 instance, all ten ring slots, into registers).
//     Only lr_table[i] waits for the counter: two dependent trips, where
//     a step that reads the counter first and the ring after it takes
//     five or more.  A thread with more columns loads the next one's
//     before it stores the current one's.
//   * The window-10 instance (every path's default window) takes the min
//     of the ring's log-norms with warp shuffles and each slot's scale from
//     its lane; unfilled slots are masked and the current slot picked by
//     predication, and the sum runs in slot order 0 .. filled - 1 as
//     before, so the agreement with the plain version holds as it did.
//     Any other window takes the runtime-window instance: the scales go
//     through shared memory and the ring is read slot by slot.
//   * At small P (up to one block's share of a ring row, 2 KB: 512 f32 or
//     256 f64 columns) a run is one block, a thread a column.  Above it a
//     run is a thread-block cluster of up to 16 blocks (launched with
//     cudaLaunchKernelEx and a cluster dimension; above 8 after
//     cudaFuncAttributeNonPortableClusterSizeAllowed), K runs K clusters,
//     each block a share of the columns.  Each block reads the counter and
//     the ring's log-norms itself; a cluster barrier orders every block's
//     reads of them before block rank 0 writes them (ring_ln[slot],
//     values[i], log_norms[i]) and advances the counter.  A refused launch
//     (a cluster the card will not schedule) returns its error, which the
//     wrapper raises.
// launch_floor launches an empty kernel the same way, for the practical
// floor beside the step's times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;   // a block's threads, either instance
constexpr int MAX_CLUSTER = 16;    // blocks a run
constexpr int PORTABLE_CLUSTER = 8;
constexpr int WINDOW = 10;         // the unrolled instance's window
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }

// this block's rank in its cluster, the cluster's blocks, and the cluster
// barrier (arrive with release, wait with acquire semantics)
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return int(r);
}
__device__ __forceinline__ int cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return int(n);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// min that propagates NaN, as jnp.min and torch.min do
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// a column's inputs that do not depend on the iteration; W > 0 holds the
// whole ring column
template <typename T, int W>
struct Column {
  T g, x, tail;
  T ring[W > 0 ? W : 1];
};

template <typename T, int W>
__device__ __forceinline__ void load_column(
    Column<T, W>& c, const T* __restrict__ grad, const T* __restrict__ param,
    const T* __restrict__ tail_sum, const T* __restrict__ ring_grads,
    int64_t kP, int64_t kw, int P, int p) {
  c.g = grad[kP + p];
  c.x = param[kP + p];
  c.tail = tail_sum[kP + p];
  if constexpr (W > 0) {
#pragma unroll
    for (int s = 0; s < W; ++s) c.ring[s] = ring_grads[(kw + s) * P + p];
  }
}

// W > 0: the window is W (<= 32), the ring column in registers, the scales
// a warp's lanes.  W == 0: the window is `window_arg`, the scales in shared
// memory.  CLUSTER: a run is a cluster of blocks, else one block.
template <typename T, int W, bool CLUSTER>
__global__ void __launch_bounds__(MAX_THREADS)
    adagrad_step_kernel(const T* __restrict__ grad,
                        const T* __restrict__ value,
                        const T* __restrict__ log_norm,
                        const T* __restrict__ lr_table,
                        int64_t* __restrict__ counter, T* __restrict__ param,
                        T* __restrict__ ring_grads, T* __restrict__ ring_ln,
                        T* __restrict__ values, T* __restrict__ log_norms,
                        T* __restrict__ params, T* __restrict__ tail_sum,
                        int P, int window_arg, int64_t n_iters,
                        int64_t tail_start, T eps) {
  extern __shared__ unsigned char smem[];
  const int window = W > 0 ? W : window_arg;
  int blocks = 1, rank = 0;
  if constexpr (CLUSTER) {
    blocks = cluster_blocks();
    rank = cluster_rank();
  }
  const int64_t k = blockIdx.x / blocks;
  const int64_t kP = k * P, kw = k * window, kn = k * n_iters;
  const int stride = blocks * blockDim.x;
  const int lane = threadIdx.x & 31;
  const bool writer = rank == 0 && threadIdx.x == 0;
  int p = rank * blockDim.x + threadIdx.x;

  // 1. every load that does not wait for the iteration, at once
  const int64_t i = counter[k];
  const T ln = log_norm != nullptr ? log_norm[k] : T(0);
  const T val = writer ? value[k] : T(0);
  T ln_lane = T(0);
  if (W > 0 && lane < W) ln_lane = ring_ln[kw + lane];
  Column<T, W> cur;
  if (p < P) load_column(cur, grad, param, tail_sum, ring_grads, kP, kw, P, p);

  // the drivers never step past the run; a counter out of range writes
  // nothing, and the driver's final check of the counter reports it.  Every
  // block of a run reads the same counter, so all of them return.
  if (i < 0 || i >= n_iters) return;
  // 2. the one load that waits for the counter
  const T lr = lr_table[kn + i];
  const int slot = int(i % window);
  const int filled = i + 1 < window ? int(i + 1) : window;

  // 3. each filled slot's scale exp(min - ln_s)
  T scale[W > 0 ? W : 1];
  T* shared_scale = reinterpret_cast<T*>(smem);
  if constexpr (W > 0) {
    const T ln_s = lane == slot ? ln : ln_lane;
    T mn = lane < filled ? ln_s : T(INFINITY);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = nan_min(mn, __shfl_xor_sync(FULL, mn, off));
    const T mine = lane < filled ? d_exp(mn - ln_s) : T(0);
#pragma unroll
    for (int s = 0; s < W; ++s) scale[s] = __shfl_sync(FULL, mine, s);
  } else {
    T mn = T(INFINITY);
    for (int s = 0; s < filled; ++s)
      mn = nan_min(mn, s == slot ? ln : ring_ln[kw + s]);
    for (int s = threadIdx.x; s < filled; s += blockDim.x)
      shared_scale[s] = d_exp(mn - (s == slot ? ln : ring_ln[kw + s]));
    __syncthreads();
  }

  // 4. the update of each of this thread's columns
  while (p < P) {
    const int q = p + stride;
    Column<T, W> next;
    if (q < P)
      load_column(next, grad, param, tail_sum, ring_grads, kP, kw, P, q);
    T accum = T(0);
    if constexpr (W > 0) {
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const T t = scale[s] * (s == slot ? cur.g : cur.ring[s]);
        if (s < filled) accum += t * t;
      }
    } else {
      for (int s = 0; s < filled; ++s) {
        const T gs = s == slot ? cur.g : ring_grads[(kw + s) * P + p];
        const T t = shared_scale[s] * gs;
        accum += t * t;
      }
    }
    ring_grads[(kw + slot) * P + p] = cur.g;  // a thread's own column
    const T x = cur.x - lr * cur.g / d_sqrt(eps + accum);
    param[kP + p] = x;
    if (params != nullptr) params[(kn + i) * P + p] = x;
    if (i >= tail_start) tail_sum[kP + p] = cur.tail + x;
    cur = next;
    p = q;
  }

  // 5. every thread of the run has read the ring's log-norms and i
  if constexpr (CLUSTER)
    cluster_sync();
  else
    __syncthreads();
  if (writer) {
    ring_ln[kw + slot] = ln;
    values[kn + i] = val;
    log_norms[kn + i] = ln;
    counter[k] = i + 1;
  }
}

__global__ void launch_floor_kernel(int) {}

// Allow `kernel` clusters above the portable 8 blocks, once a kernel: the
// caller keeps the result in a static of its own instance.
template <typename Kernel>
cudaError_t allow_nonportable(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launch `kernel` on `blocks` blocks of `threads`, `cluster` blocks a
// cluster (1: no cluster), the way every launch of this library goes.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, int threads, int cluster,
           size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return int(err != cudaSuccess ? err : last);
}

template <typename T, int W, bool CLUSTER>
int launch_instance(const void* grad, const void* value, const void* log_norm,
                    const void* lr_table, void* counter, void* param,
                    void* ring_grads, void* ring_ln, void* values,
                    void* log_norms, void* params, void* tail_sum, int K,
                    int P, int window, long long n_iters,
                    long long tail_start, double eps, int threads,
                    int cluster, void* stream) {
  const size_t smem = W > 0 ? 0 : size_t(window) * sizeof(T);
  if (cluster > PORTABLE_CLUSTER) {
    static const cudaError_t allowed =  // thread-safe, once an instance
        allow_nonportable(adagrad_step_kernel<T, W, CLUSTER>);
    if (allowed != cudaSuccess) return int(allowed);
  }
  return launch(adagrad_step_kernel<T, W, CLUSTER>, K * cluster, threads,
                cluster, smem, stream, static_cast<const T*>(grad),
                static_cast<const T*>(value),
                static_cast<const T*>(log_norm),
                static_cast<const T*>(lr_table),
                static_cast<int64_t*>(counter), static_cast<T*>(param),
                static_cast<T*>(ring_grads), static_cast<T*>(ring_ln),
                static_cast<T*>(values), static_cast<T*>(log_norms),
                static_cast<T*>(params), static_cast<T*>(tail_sum), P, window,
                int64_t(n_iters), int64_t(tail_start), T(eps));
}

template <typename T>
int launch_step(const void* grad, const void* value, const void* log_norm,
                const void* lr_table, void* counter, void* param,
                void* ring_grads, void* ring_ln, void* values,
                void* log_norms, void* params, void* tail_sum, int K, int P,
                int window, long long n_iters, long long tail_start,
                double eps, int unrolled, int threads, int cluster,
                void* stream) {
  if (K < 1 || P < 1 || window < 1 || n_iters < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || (unrolled && window != WINDOW) ||
      size_t(window) * sizeof(T) > 48 * 1024)
    return int(cudaErrorInvalidValue);
  auto run = unrolled ? (cluster > 1 ? launch_instance<T, WINDOW, true>
                                     : launch_instance<T, WINDOW, false>)
                      : (cluster > 1 ? launch_instance<T, 0, true>
                                     : launch_instance<T, 0, false>);
  return run(grad, value, log_norm, lr_table, counter, param, ring_grads,
             ring_ln, values, log_norms, params, tail_sum, K, P, window,
             n_iters, tail_start, eps, threads, cluster, stream);
}

}  // namespace

extern "C" {

int adagrad_step_f32(const void* grad, const void* value,
                     const void* log_norm, const void* lr_table,
                     void* counter, void* param, void* ring_grads,
                     void* ring_ln, void* values, void* log_norms,
                     void* params, void* tail_sum, int K, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     int unrolled, int threads, int cluster, void* stream) {
  return launch_step<float>(grad, value, log_norm, lr_table, counter, param,
                            ring_grads, ring_ln, values, log_norms, params,
                            tail_sum, K, P, window, n_iters, tail_start, eps,
                            unrolled, threads, cluster, stream);
}

int adagrad_step_f64(const void* grad, const void* value,
                     const void* log_norm, const void* lr_table,
                     void* counter, void* param, void* ring_grads,
                     void* ring_ln, void* values, void* log_norms,
                     void* params, void* tail_sum, int K, int P, int window,
                     long long n_iters, long long tail_start, double eps,
                     int unrolled, int threads, int cluster, void* stream) {
  return launch_step<double>(grad, value, log_norm, lr_table, counter, param,
                             ring_grads, ring_ln, values, log_norms, params,
                             tail_sum, K, P, window, n_iters, tail_start, eps,
                             unrolled, threads, cluster, stream);
}

// an empty kernel on `blocks` blocks of `threads`, `cluster` a cluster,
// launched as the step is: the card's floor under any launch of this size
int launch_floor(int blocks, int threads, int cluster, void* stream) {
  if (blocks < 1 || threads < 1 || threads > MAX_THREADS || cluster < 1 ||
      cluster > MAX_CLUSTER || blocks % cluster != 0)
    return int(cudaErrorInvalidValue);
  if (cluster > PORTABLE_CLUSTER) {
    static const cudaError_t allowed = allow_nonportable(launch_floor_kernel);
    if (allowed != cudaSuccess) return int(allowed);
  }
  return launch(launch_floor_kernel, blocks, threads, cluster, 0, stream, 0);
}

}  // extern "C"
