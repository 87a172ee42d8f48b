// The Student-t and chi-square samplers' arithmetic after their generator
// calls, for Hopper (sm_90a).
//
// Built by viabel_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes; the Python wrapper lives in
// viabel_tpu_torch/ops/t_sample.py beside its plain PyTorch version, and
// viabel_tpu_torch/distributions.py makes the generator calls around it.
//
// It replaces no Pallas kernel: the JAX package's rejection-free sampler
// (viabel_tpu/distributions.py:42-62, the grouped -sum log u, and :82-110,
// z sqrt(df / chi2)) was left to XLA's fusion.  PyTorch runs that
// composition as ~54 elementwise kernels after the df // 2 + 1 generator
// calls of a df-40 draw (a clamp and a product a uniform, then ones, logs,
// sums, the reciprocal, sqrt and the final product), each reading and
// writing whole buffers of the draw's shape.
//
// t_from_uniforms is one launch a group of at most GROUP = 10 uniforms, the
// plain path's own grouping (a product of 10 uniforms, each clamped to
// FLT_MIN / DBL_MIN, is taken before its log).  Element by element:
//   prod  = max(u_0, tiny) * max(u_1, tiny) * ... (in the group's order)
//   total = (first ? 0 : total) - log(prod)       (no log for no uniforms)
// and the last group's launch writes, in place of total,
//   chi2 = 2 total (+ z1 z1 for odd df), or t = z sqrt((1 / chi2) df).
// Every step is rounded as PyTorch rounds it, one IEEE operation at a
// time (the intrinsics below keep -O3 from contracting a product and a sum
// into an FMA; df / chi2 is PyTorch's reciprocal and then a product), so
// the draws equal the plain path's bit for bit.  The generator calls stay
// outside, in the plain path's order, so the bits drawn and the
// generator's offset afterwards are the ones the benchmark's reference
// replays.
//
// What bounds it on an H100: bytes.  The draw itself needs its 20
// uniforms and z read and t written: 22 values of 4 bytes an element,
// 2.2 GB at (2.5e6, 10) float32, 0.66 ms at 3.35 TB/s.  The two launches
// of a df-40 draw move two values more, total written by the first and
// read by the second: 2.4 GB, 0.72 ms (the ~54 kernels it replaces move
// about 11.5 GB).  So each thread takes 16 bytes of every buffer of its
// group at a time (float4 / double2), all of the group's loads issued
// before the first product, over a grid-stride loop on a grid of resident
// blocks on every SM, with a scalar tail; the wrapper refuses a buffer
// that is not 16-byte aligned.  It allocates nothing and never
// synchronizes, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int GROUP = 10;     // uniforms a launch at most
constexpr int THREADS = 256;

template <typename T>
struct alignas(16) Pack {
  static constexpr int W = 16 / sizeof(T);
  T x[W];
};

// each operation rounded once, as PyTorch's kernels round it
template <typename T> struct Ieee;
template <> struct Ieee<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float rcp(float a) {
    return __fdiv_rn(1.0f, a);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
};
template <> struct Ieee<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double rcp(double a) {
    return __ddiv_rn(1.0, a);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
};

template <typename T>
struct Args {
  const T* u[GROUP];  // the group's uniforms, n_u of them
  int n_u;
  T* total;           // read unless first; written (total, chi2 or t)
  const T* z;         // the t form's normals (last launch), else null
  const T* z1;        // odd df's extra normals (last launch), else null
  long long n;        // elements of every buffer
  T df;
  int first, last;
};

// PyTorch's clamp_min: NaN stays NaN, anything below tiny becomes tiny
template <typename T>
__device__ __forceinline__ T clamp_tiny(T u) {
  const T tiny = Ieee<T>::tiny();
  return u < tiny ? tiny : u;
}

// one element: the group's uniforms u, total before the launch, z, z1
template <typename T>
__device__ __forceinline__ T combine(const Args<T>& a, const T (&u)[GROUP],
                                     T total, T z, T z1) {
  using F = Ieee<T>;
  if (a.n_u > 0) {
    T prod = clamp_tiny(u[0]);  // 1 * u_0, exact
#pragma unroll
    for (int j = 1; j < GROUP; ++j) {
      if (j < a.n_u) prod = F::mul(prod, clamp_tiny(u[j]));
    }
    total = F::sub(total, F::log(prod));
  }
  if (!a.last) return total;
  T chi2 = F::mul(T(2), total);
  if (a.z1 != nullptr) chi2 = F::add(chi2, F::mul(z1, z1));
  if (a.z == nullptr) return chi2;
  return F::mul(z, F::sqrt(F::mul(F::rcp(chi2), a.df)));
}

template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* p, long long c) {
  return reinterpret_cast<const Pack<T>*>(p)[c];  // one 16-byte load
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    t_from_uniforms_kernel(const Args<T> a) {
  constexpr int W = Pack<T>::W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long chunks = a.n / W;
  for (long long c = tid; c < chunks; c += stride) {
    Pack<T> u[GROUP] = {}, total = {}, z = {}, z1 = {};
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (j < a.n_u) u[j] = load_pack(a.u[j], c);
    }
    if (!a.first) total = load_pack<T>(a.total, c);
    if (a.last && a.z != nullptr) z = load_pack(a.z, c);
    if (a.last && a.z1 != nullptr) z1 = load_pack(a.z1, c);
    Pack<T> out;
#pragma unroll
    for (int l = 0; l < W; ++l) {
      T ul[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) ul[j] = u[j].x[l];
      out.x[l] = combine(a, ul, total.x[l], z.x[l], z1.x[l]);
    }
    reinterpret_cast<Pack<T>*>(a.total)[c] = out;
  }
  for (long long i = chunks * W + tid; i < a.n; i += stride) {
    T ul[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) ul[j] = j < a.n_u ? a.u[j][i] : T(0);
    const T total = a.first ? T(0) : a.total[i];
    const T z = a.last && a.z != nullptr ? a.z[i] : T(0);
    const T z1 = a.last && a.z1 != nullptr ? a.z1[i] : T(0);
    a.total[i] = combine(a, ul, total, z, z1);
  }
}

template <typename T>
int launch(const void* const* u, int n_u, void* total, const void* z,
           const void* z1, long long n, double df, int first, int last,
           void* stream) {
  if (n_u < 0 || n_u > GROUP || (n_u == 0 && !(first && last)))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  Args<T> a{};
  for (int j = 0; j < n_u; ++j) a.u[j] = static_cast<const T*>(u[j]);
  a.n_u = n_u;
  a.total = static_cast<T*>(total);
  a.z = static_cast<const T*>(z);
  a.z1 = static_cast<const T*>(z1);
  a.n = n;
  a.df = static_cast<T>(df);
  a.first = first;
  a.last = last;
  // a grid of resident blocks on every SM, or fewer where the work is less
  static int resident = 0;
  if (resident == 0) {
    int r = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r, t_from_uniforms_kernel<T>, THREADS, 0);
    resident = r > 0 ? r : 1;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long W = Pack<T>::W;
  const long long work = n / W + n % W;
  const long long want = (work + THREADS - 1) / THREADS;
  const long long most = (long long)resident * (sms > 0 ? sms : 1);
  const int blocks = (int)(want < most ? want : most);
  t_from_uniforms_kernel<T><<<blocks, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u: a host array of n_u device pointers (n_u 0 only for a df-1 draw's one
// launch, first and last); z null for the chi-square form; z1 null for
// even df or a launch before the last; every buffer 16-byte aligned
int t_from_uniforms_f32(const void* const* u, int n_u, void* total,
                        const void* z, const void* z1, long long n,
                        double df, int first, int last, void* stream) {
  return launch<float>(u, n_u, total, z, z1, n, df, first, last, stream);
}

int t_from_uniforms_f64(const void* const* u, int n_u, void* total,
                        const void* z, const void* z1, long long n,
                        double df, int first, int last, void* stream) {
  return launch<double>(u, n_u, total, z, z1, n, df, first, last, stream);
}

}  // extern "C"
