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
// What bounds them on an H100 (PERF.md has the times).  K2 writes 4 B of
// lw a sample and reads nothing per sample, so it is bound by operations:
// Philox's 10 rounds and Box-Muller for each group of 4 normals, the
// transform and log q, and the model density, which at the regression's
// N = 100, d = 10 is ~2600 (the mu loop alone is 2 N d).  philox_normal
// writes n d values and spends ~50 instructions on each (a logarithm, a
// square root and a sincospi a pair, in full precision), so it too is
// bound by the SMs' issue rate before its bytes.  Its design: a block owns
// a tile of consecutive samples whose z is one contiguous run; threads
// compute (sample, group) items into shared memory, stepping through them
// without a division, the last group of a row computing only the pair it
// keeps; the run then leaves in whole 16-byte stores, neighbouring
// threads on neighbouring words, with scalar stores for the unaligned head
// and tail.  The shared-memory tile is shifted so that a word is aligned
// there exactly where it is aligned in device memory.

#include "bound_pass.cuh"

using namespace bound_pass;

namespace {

// philox_normal's tile is 32 KB of z a block; its launch bound caps the
// kernel at 32 registers a thread (6 blocks are resident on an SM, which
// the tile's shared memory decides).
constexpr int NORMAL_TILE_BYTES = 32 * 1024;
constexpr int NORMAL_MIN_BLOCKS = 8;
constexpr int NORMAL_THREADS = 256;
constexpr int NORMAL_MAX_GRID = 132 * 16;  // philox_bits' grid

// How philox_normal cuts z (n, d) into tiles of at most TILE values of T,
// one tile a block.
// d <= TILE: a tile is `rows` whole rows, one contiguous run; where they
// fit, a multiple of the block (every thread then computes as many items)
// or of the warp (a warp's lanes then share a group).  d > TILE: a tile
// is one segment of `seg` columns (a multiple of 4, so groups do not
// straddle segments) of one row.
template <typename T>
struct NormalTiling {
  static constexpr int TILE = NORMAL_TILE_BYTES / int(sizeof(T));
  int rows, seg, n_seg;
  int64_t tiles;

  NormalTiling(int64_t n, int d) {
    if (d <= TILE) {
      rows = TILE / d;
      if (rows >= NORMAL_THREADS)
        rows -= rows % NORMAL_THREADS;
      else if (rows >= 32)
        rows -= rows % 32;
      seg = d;
      n_seg = 1;
    } else {
      rows = 1;
      seg = TILE;
      n_seg = (d + TILE - 1) / TILE;
    }
    tiles = ((n + rows - 1) / rows) * n_seg;
  }
};

// A block's walk over the items (major, minor) of a `width`-wide grid in
// steps of NORMAL_THREADS items, without a division in the loop: where
// thread `tid` starts and how far one step takes it.
struct ItemWalk {
  int major, minor, step_major, step_minor;
  __device__ ItemWalk(int tid, int width) {
    if (width >= NORMAL_THREADS) {
      major = 0;
      minor = tid;
      step_major = width == NORMAL_THREADS;
      step_minor = width == NORMAL_THREADS ? 0 : NORMAL_THREADS;
    } else {
      major = tid / width;
      minor = tid % width;
      step_major = NORMAL_THREADS / width;
      step_minor = NORMAL_THREADS % width;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NORMAL_THREADS, NORMAL_MIN_BLOCKS)
    philox_normal_kernel(int64_t n, int d, uint64_t start, uint2 key,
                         uint32_t offset, NormalTiling<T> tiling,
                         T* __restrict__ z) {
  constexpr int VEC = 16 / int(sizeof(T));  // values in a 16-byte word
  __shared__ Pack<T, VEC> tile_words[NormalTiling<T>::TILE / VEC + 1];
  const int tid = threadIdx.x;

  // the block's tile: rows [s0, s0 + ts) x columns [c0, c0 + cw), a run of
  // ts * cw values from z + s0 * d + c0 (ts = 1 unless cw = d)
  int64_t row_tile = blockIdx.x;
  int segment = 0;
  if (tiling.n_seg > 1) {
    row_tile = blockIdx.x / tiling.n_seg;
    segment = int(blockIdx.x - row_tile * tiling.n_seg);
  }
  const int64_t s0 = row_tile * tiling.rows;
  const int ts = int(n - s0 < tiling.rows ? n - s0 : tiling.rows);
  const int c0 = segment * tiling.seg;
  const int cw = d - c0 < tiling.seg ? d - c0 : tiling.seg;
  const int groups = (cw + 3) / 4;
  const int len = ts * cw;
  T* dst = z + (s0 * d + c0);
  // shift the tile so that 16-byte words align in both memories
  const int shift = int((reinterpret_cast<uintptr_t>(dst) / sizeof(T)) % VEC);
  T* tile = reinterpret_cast<T*>(tile_words) + shift;

  // Items in group-major order, item = g * ts + ls: the 32 lanes of a
  // warp share g wherever ts is a multiple of 32, so a short last group
  // skips its second pair as a warp.
  const ItemWalk walk(tid, ts);
  for (int g = walk.major, ls = walk.minor; g < groups;) {
    uint4 b = philox_group(start + uint64_t(s0 + ls), uint32_t(c0 / 4 + g),
                           offset, key);
    T* out = tile + ls * cw + 4 * g;
    T z0, z1;
    box_muller(b.x, b.y, z0, z1);
    out[0] = z0;
    if (4 * g + 1 < cw) out[1] = z1;
    if (4 * g + 2 < cw) {  // the pair a short last group drops
      box_muller(b.z, b.w, z0, z1);
      out[2] = z0;
      if (4 * g + 3 < cw) out[3] = z1;
    }
    g += walk.step_major;
    ls += walk.step_minor;
    if (ls >= ts) {
      ls -= ts;
      ++g;
    }
  }
  __syncthreads();

  // the run leaves in 16-byte words, neighbouring threads on neighbouring
  // words; its unaligned head and tail value by value
  int head = (VEC - shift) % VEC;
  if (head > len) head = len;
  const int words = (len - head) / VEC;
  const int tail = len - head - words * VEC;
  if (tid < head) dst[tid] = tile[tid];
  if (tid < tail)
    dst[head + words * VEC + tid] = tile[head + words * VEC + tid];
  const Pack<T, VEC>* src_words =
      reinterpret_cast<const Pack<T, VEC>*>(tile + head);
  Pack<T, VEC>* dst_words = reinterpret_cast<Pack<T, VEC>*>(dst + head);
  for (int w = tid; w < words; w += NORMAL_THREADS)
    dst_words[w] = src_words[w];
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
  if (n < 1 || d < 1) return int(cudaErrorInvalidValue);
  NormalTiling<T> tiling(n, d);
  if (tiling.tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  philox_normal_kernel<T><<<int(tiling.tiles), NORMAL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, d, start, key_of(seed), offset, tiling, static_cast<T*>(z));
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
