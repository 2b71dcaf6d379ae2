// Training-mode BatchNorm for Hopper (sm_90a): the batch statistics, the
// normalisation, and the backward pass's channel sums and input gradient,
// over channels-last (N, H, W, C) tensors of bfloat16 or float32 with
// float32 arithmetic throughout.  Channels-last is the layout the port's
// encoder runs in on the card: the regressor's input is the NHWC proxy,
// and cuDNN's convolutions keep its layout.
//
// Replaces no TPU kernel.  The JAX package's encoder uses flax's BatchNorm,
// which XLA fuses on the TPU; the port wrote the same arithmetic as plain
// PyTorch (models/resnet.py::BatchNorm2d), which costs about 45 launches a
// layer and several float32 copies of every activation in each direction.
// The plain PyTorch version of these kernels sits beside their wrapper in
// models/resnet.py (`batchnorm_*_reference`) and is the definition they are
// held to.
//
// Four kernels, each one pass over the activations, seen as an (M, C)
// row-major matrix, M = N * H * W:
//   1. straps_batchnorm_stats: per channel the float32 [sum x, sum x^2];
//   2. straps_batchnorm_normalize: mean, flax's variance E[x^2] - E[x]^2
//      clamped at 0, mul = rsqrt(var + eps) * weight, the running
//      statistics' update, then y = (x - mean) * mul + bias, stored in x's
//      dtype;
//   3. straps_batchnorm_backward_sums: per channel [sum dy,
//      sum dy * (x - mean)], which give the bias's and the weight's
//      gradients;
//   4. straps_batchnorm_backward_dx:
//      dx = mul * ((dy - sum dy / N) - (x - mean) * (k * sum dy (x - mean) / N)),
//      k = rsqrt(var + eps)^2, or 0 where the clamp was active (autograd of
//      the clamp passes no gradient to the variance there).
// Over a data mesh the wrapper all-reduces the (2, C) sums between 1 and 2
// and between 3 and 4, and N is the global batch's count.
//
// What bounds it on this card: bytes.  A layer does a few float
// operations per element against 16 bytes moved (x read twice and y
// written forward, dy and x read twice and dx written backward, bfloat16),
// far below the ~295 operations a byte where the tensor cores would bound
// it.  The design therefore reads and writes each element once a kernel,
// with 16-byte loads and stores along the channels, and fills the card
// whatever the layer's shape:
//   * a block is `lanes` (a power of two up to 32) vectors of channels by
//     256 / lanes rows, so a warp reads 512 contiguous bytes; the grid is
//     (channel tiles, row slices), the slices chosen by the wrapper
//     (models/resnet.py::batchnorm_geometry) so that every layer has
//     several blocks a multiprocessor, from the stem's 64 channels at
//     128^2 to layer4's 2048 at 8^2;
//   * the reductions (1 and 3) keep one float32 accumulator a channel in
//     each thread, add the block's rows in shared memory in row order, and
//     write each slice's partial sums; the last block of a channel tile to
//     finish (a counter per tile, reset by that block) adds the slices'
//     partials in slice order.  Both combines run in double precision and
//     round once to the float32 sums.  No float atomics: the sums, and so
//     every output, repeat bit for bit from run to run;
//   * kernels 2 and 4 compute their tile's coefficients once a block and
//     stream the rows through;
//   * a product and a sum of the normalisation and of dx are rounded
//     separately (__fmul_rn, __fadd_rn), in the order of the plain version,
//     so no fused multiply-add moves an output by the contraction alone.
// The kernels allocate nothing: the wrapper passes the outputs, the (S, 2,
// C) float64 partials, and the tile counters (zero between launches) of
// the stream it launches on, so that launches on two streams at once never
// share counters; the launches of one stream run in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // rows in flight a thread and input
constexpr int kMaxVec = 8;           // elements of a 16-byte bfloat16 vector
constexpr int kMaxTile = 32 * kMaxVec;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements as floats; V * sizeof(T) == 16 is one 16-byte load.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(w[k] << 16);
        f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(w[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_float(p[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]));
        w[k] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(f[k]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) store_one(p + k, f[k]);
  }
}

// The thread's place: `lanes` vectors of V channels across a block's tile
// (blockIdx.x), 256 / lanes rows at a time over the block's row slice
// (blockIdx.y of gridDim.y).
struct Place {
  int lane, rlane, rows, tile_width, col, ch, row0, row1;
  bool active;

  __device__ Place(int m, int c, int lanes, int v) {
    lane = threadIdx.x % lanes;
    rlane = threadIdx.x / lanes;
    rows = kThreads / lanes;
    tile_width = lanes * v;
    col = lane * v;                             // the thread's first column of the tile
    ch = blockIdx.x * tile_width + col;         // its first channel
    active = ch < c;
    const int s = blockIdx.y, slices = gridDim.y;
    row0 = static_cast<int>(static_cast<long long>(m) * s / slices);
    row1 = static_cast<int>(static_cast<long long>(m) * (s + 1) / slices);
  }
};

// Per column of the tile (in threads col = threadIdx.x < tile_width, channel
// blockIdx.x * tile_width + col < c): the tile's (a, b) summed over every
// row slice, in row order within a block and in slice order across blocks,
// in double precision (a float32 running sum over hundreds of slices would
// lose what a channel of near-constant values keeps of its variance).
// Returns true in the one block of the tile that holds those sums.
template <int V>
__device__ bool tile_sums(const float (&a)[V], const float (&b)[V], const Place& p,
                          double* partials, int* counters, int c, double& sa, double& sb) {
  __shared__ float part[2][kThreads * kMaxVec];
  __shared__ bool last;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    part[0][p.rlane * p.tile_width + p.col + k] = a[k];
    part[1][p.rlane * p.tile_width + p.col + k] = b[k];
  }
  __syncthreads();
  const int col = threadIdx.x;
  const int ch = blockIdx.x * p.tile_width + col;
  const bool mine = col < p.tile_width && ch < c;
  sa = 0.0;
  sb = 0.0;
  if (mine) {
    for (int r = 0; r < p.rows; ++r) {
      sa += part[0][r * p.tile_width + col];
      sb += part[1][r * p.tile_width + col];
    }
  }
  if (gridDim.y == 1) return true;
  if (mine) {
    partials[static_cast<size_t>(blockIdx.y) * 2 * c + ch] = sa;
    partials[(static_cast<size_t>(blockIdx.y) * 2 + 1) * c + ch] = sb;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return false;
  if (mine) {
    sa = 0.0;
    sb = 0.0;
    for (unsigned s = 0; s < gridDim.y; ++s) {
      sa += __ldcg(&partials[static_cast<size_t>(s) * 2 * c + ch]);
      sb += __ldcg(&partials[(static_cast<size_t>(s) * 2 + 1) * c + ch]);
    }
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
  return true;
}

}  // namespace

// 1. [sum x, sum x^2] per channel into sums (2, C).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    straps_batchnorm_stats(const T* __restrict__ x, double* __restrict__ partials,
                           float* __restrict__ sums, int* __restrict__ counters, int m, int c,
                           int lanes) {
  const Place p(m, c, lanes, V);
  float a[V] = {}, b[V] = {};
  if (p.active) {
    for (int r = p.row0 + p.rlane; r < p.row1; r += p.rows * kUnroll) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * p.rows;
        if (row < p.row1) {
          load_vec<T, V>(x + static_cast<size_t>(row) * c + p.ch, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += v[u][k];
          b[k] += v[u][k] * v[u][k];
        }
      }
    }
  }
  double sa, sb;
  if (tile_sums<V>(a, b, p, partials, counters, c, sa, sb)) {
    const int col = threadIdx.x, ch = blockIdx.x * p.tile_width + col;
    if (col < p.tile_width && ch < c) {
      sums[ch] = static_cast<float>(sa);
      sums[c + ch] = static_cast<float>(sb);
    }
  }
}

// 2. The channels' statistics from sums (2, C) over `count` elements, the
// running statistics' update (row slice 0), y = (x - mean) * mul + bias.
// stats (4, C) receives [mean, mul, rsqrt(var + eps), k] for the backward.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    straps_batchnorm_normalize(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ sums, const float* __restrict__ weight,
                               const float* __restrict__ bias, float* __restrict__ running_mean,
                               float* __restrict__ running_var, long long* batches_tracked,
                               float* __restrict__ stats, int m, int c, int lanes, float count,
                               float eps, float momentum, float keep) {
  __shared__ float coef[3][kMaxTile];
  const Place p(m, c, lanes, V);
  {
    const int col = threadIdx.x, ch = blockIdx.x * p.tile_width + col;
    if (col < p.tile_width && ch < c) {
      const float mean = sums[ch] / count;
      const float raw = __fsub_rn(sums[c + ch] / count, __fmul_rn(mean, mean));
      const float var = raw < 0.f ? 0.f : raw;   // NaN stays NaN, as torch.clamp
      const float r = rsqrtf(__fadd_rn(var, eps));
      const float mul = __fmul_rn(r, weight[ch]);
      coef[0][col] = mean;
      coef[1][col] = mul;
      coef[2][col] = bias[ch];
      if (blockIdx.y == 0) {
        stats[ch] = mean;
        stats[c + ch] = mul;
        stats[2 * c + ch] = r;
        stats[3 * c + ch] = raw >= 0.f ? __fmul_rn(r, r) : 0.f;
        running_mean[ch] =
            __fadd_rn(__fmul_rn(running_mean[ch], keep), __fmul_rn(mean, momentum));
        running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], keep), __fmul_rn(var, momentum));
      }
    }
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *batches_tracked += 1;
  }
  __syncthreads();
  if (!p.active) return;
  float mean[V], mul[V], shift[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = coef[0][p.col + k];
    mul[k] = coef[1][p.col + k];
    shift[k] = coef[2][p.col + k];
  }
  for (int r = p.row0 + p.rlane; r < p.row1; r += p.rows * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * p.rows;
      if (row < p.row1) load_vec<T, V>(x + static_cast<size_t>(row) * c + p.ch, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * p.rows;
      if (row < p.row1) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[u][k] = __fadd_rn(__fmul_rn(__fsub_rn(v[u][k], mean[k]), mul[k]), shift[k]);
        store_vec<T, V>(y + static_cast<size_t>(row) * c + p.ch, v[u]);
      }
    }
  }
}

// 3. [sum dy, sum dy * (x - mean)] per channel into sums (2, C), and the
// bias's and weight's gradients (this process's rows).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    straps_batchnorm_backward_sums(const T* __restrict__ dy, const T* __restrict__ x,
                                   const float* __restrict__ stats, double* __restrict__ partials,
                                   float* __restrict__ sums, int* __restrict__ counters,
                                   float* __restrict__ dweight, float* __restrict__ dbias, int m,
                                   int c, int lanes) {
  const Place p(m, c, lanes, V);
  float a[V] = {}, b[V] = {};
  if (p.active) {
    float mean[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mean[k] = stats[p.ch + k];
    for (int r = p.row0 + p.rlane; r < p.row1; r += p.rows * kUnroll) {
      float g[kUnroll][V], v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * p.rows;
        if (row < p.row1) {
          const size_t off = static_cast<size_t>(row) * c + p.ch;
          load_vec<T, V>(dy + off, g[u]);
          load_vec<T, V>(x + off, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            g[u][k] = 0.f;
            v[u][k] = mean[k];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += g[u][k];
          b[k] += __fmul_rn(g[u][k], __fsub_rn(v[u][k], mean[k]));
        }
      }
    }
  }
  double sa, sb;
  if (tile_sums<V>(a, b, p, partials, counters, c, sa, sb)) {
    const int col = threadIdx.x, ch = blockIdx.x * p.tile_width + col;
    if (col < p.tile_width && ch < c) {
      const float fa = static_cast<float>(sa), fb = static_cast<float>(sb);
      sums[ch] = fa;
      sums[c + ch] = fb;
      dbias[ch] = fa;
      dweight[ch] = __fmul_rn(fb, stats[2 * c + ch]);
    }
  }
}

// 4. dx = mul * ((dy - sum dy / N) - (x - mean) * (k * sum dy (x - mean) / N)).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    straps_batchnorm_backward_dx(const T* __restrict__ dy, const T* __restrict__ x,
                                 const float* __restrict__ stats, const float* __restrict__ sums,
                                 T* __restrict__ dx, int m, int c, int lanes, float count) {
  const Place p(m, c, lanes, V);
  if (!p.active) return;
  float mean[V], mul[V], c1[V], c2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = p.ch + k;
    mean[k] = stats[ch];
    mul[k] = stats[c + ch];
    c1[k] = sums[ch] / count;
    c2[k] = __fmul_rn(sums[c + ch], stats[3 * c + ch]) / count;
  }
  for (int r = p.row0 + p.rlane; r < p.row1; r += p.rows * kUnroll) {
    float g[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * p.rows;
      if (row < p.row1) {
        const size_t off = static_cast<size_t>(row) * c + p.ch;
        load_vec<T, V>(dy + off, g[u]);
        load_vec<T, V>(x + off, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * p.rows;
      if (row < p.row1) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          g[u][k] = __fmul_rn(mul[k], __fsub_rn(__fsub_rn(g[u][k], c1[k]),
                                                __fmul_rn(__fsub_rn(v[u][k], mean[k]), c2[k])));
        store_vec<T, V>(dx + static_cast<size_t>(row) * c + p.ch, g[u]);
      }
    }
  }
}

namespace {

// A launch of kernel<T, vec> over (tiles, slices) blocks, tiles from the
// channels, the vector width and the lanes.
template <typename T, template <typename, int> class K, typename... Args>
int launch(int vec, int c, int lanes, int slices, void* stream, Args... args) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || slices < 1 || slices > 65535)
    return cudaErrorInvalidValue;
  const int tiles = ((c + vec - 1) / vec + lanes - 1) / lanes;
  const dim3 grid(tiles, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16 / static_cast<int>(sizeof(T)) && c % vec == 0) {
    K<T, 16 / static_cast<int>(sizeof(T))>::run(grid, s, args...);
  } else if (vec == 1) {
    K<T, 1>::run(grid, s, args...);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
struct Stats {
  template <typename... A>
  static void run(dim3 grid, cudaStream_t s, A... a) {
    straps_batchnorm_stats<T, V><<<grid, kThreads, 0, s>>>(a...);
  }
};
template <typename T, int V>
struct Normalize {
  template <typename... A>
  static void run(dim3 grid, cudaStream_t s, A... a) {
    straps_batchnorm_normalize<T, V><<<grid, kThreads, 0, s>>>(a...);
  }
};
template <typename T, int V>
struct BackwardSums {
  template <typename... A>
  static void run(dim3 grid, cudaStream_t s, A... a) {
    straps_batchnorm_backward_sums<T, V><<<grid, kThreads, 0, s>>>(a...);
  }
};
template <typename T, int V>
struct BackwardDx {
  template <typename... A>
  static void run(dim3 grid, cudaStream_t s, A... a) {
    straps_batchnorm_backward_dx<T, V><<<grid, kThreads, 0, s>>>(a...);
  }
};

bool shape_ok(int m, int c) { return m >= 1 && c >= 1; }

}  // namespace

// The entry points.  x, y, dy, dx: channels-last (M, C) of `dtype` (0
// float32, 1 bfloat16), 16-byte aligned where `vec` > 1; `vec` is 16 bytes
// of the dtype (C a multiple of it) or 1; `lanes` a power of two up to 32;
// `slices` the row slices (partials: (slices, 2, C) float64; counters: one
// int32 a channel tile, zero); sums (2, C), stats (4, C) and every (C,)
// vector float32; batches_tracked one int64.  Each returns the launch's
// CUDA error (0 on success), or cudaErrorInvalidValue for another dtype or
// geometry.

extern "C" int batchnorm_stats_launch(const void* x, double* partials, float* sums,
                                      int* counters, int dtype, int m, int c, int vec, int lanes,
                                      int slices, void* stream) {
  if (!shape_ok(m, c)) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float, Stats>(vec, c, lanes, slices, stream, static_cast<const float*>(x),
                                partials, sums, counters, m, c, lanes);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, Stats>(vec, c, lanes, slices, stream,
                                        static_cast<const __nv_bfloat16*>(x), partials, sums,
                                        counters, m, c, lanes);
  return cudaErrorInvalidValue;
}

extern "C" int batchnorm_normalize_launch(const void* x, void* y, const float* sums,
                                          const float* weight, const float* bias,
                                          float* running_mean, float* running_var,
                                          long long* batches_tracked, float* stats, int dtype,
                                          int m, int c, int vec, int lanes, int slices,
                                          float count, float eps, float momentum, float keep,
                                          void* stream) {
  if (!shape_ok(m, c)) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float, Normalize>(vec, c, lanes, slices, stream, static_cast<const float*>(x),
                                    static_cast<float*>(y), sums, weight, bias, running_mean,
                                    running_var, batches_tracked, stats, m, c, lanes, count, eps,
                                    momentum, keep);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, Normalize>(
        vec, c, lanes, slices, stream, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), sums, weight, bias, running_mean, running_var,
        batches_tracked, stats, m, c, lanes, count, eps, momentum, keep);
  return cudaErrorInvalidValue;
}

extern "C" int batchnorm_backward_sums_launch(const void* dy, const void* x, const float* stats,
                                              double* partials, float* sums, int* counters,
                                              float* dweight, float* dbias, int dtype, int m,
                                              int c, int vec, int lanes, int slices,
                                              void* stream) {
  if (!shape_ok(m, c)) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float, BackwardSums>(vec, c, lanes, slices, stream,
                                       static_cast<const float*>(dy),
                                       static_cast<const float*>(x), stats, partials, sums,
                                       counters, dweight, dbias, m, c, lanes);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, BackwardSums>(
        vec, c, lanes, slices, stream, static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), stats, partials, sums, counters, dweight, dbias, m,
        c, lanes);
  return cudaErrorInvalidValue;
}

extern "C" int batchnorm_backward_dx_launch(const void* dy, const void* x, const float* stats,
                                            const float* sums, void* dx, int dtype, int m, int c,
                                            int vec, int lanes, int slices, float count,
                                            void* stream) {
  if (!shape_ok(m, c)) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float, BackwardDx>(vec, c, lanes, slices, stream, static_cast<const float*>(dy),
                                     static_cast<const float*>(x), stats, sums,
                                     static_cast<float*>(dx), m, c, lanes, count);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, BackwardDx>(
        vec, c, lanes, slices, stream, static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), stats, sums, static_cast<__nv_bfloat16*>(dx), m, c,
        lanes, count);
  return cudaErrorInvalidValue;
}
