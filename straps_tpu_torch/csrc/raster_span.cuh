// Per-row span rasteriser shared by raster_packed.cu and raster_faceid.cu.
//
// Both kernels compute, per pixel centre (x + 0.5, y + 0.5), a minimum over
// the faces that cover it.  A face is four affine planes (three edges and
// the depth) `a*x + (b*y + c)`, evaluated with each product and sum rounded
// on its own (__fmul_rn / __fadd_rn), in the order of the plain PyTorch
// versions in render/cuda_raster.py, so that the outputs agree with them
// bit for bit; the pixel is covered when all three edges are >= 0.  Each
// kernel file keeps only its key: what it starts from, how a covered pixel
// turns into a key, and how the minimum key is written out.
//
// The fact the design rests on.  In one pixel row, r = fl(fl(b*py) + c) is
// fixed and an edge is e(x) = fl(fl(a*px) + r).  IEEE rounding is
// monotone, so e is nondecreasing in px for a > 0 and nonincreasing for
// a < 0: the pixels of a row that pass one edge are a suffix (a > 0) or a
// prefix (a < 0) of the row, all or none for a == +-0 (e is then r, or a
// zero, so `r >= 0` decides), and none for a NaN.  The covered pixels of a
// face in a row are therefore one interval, the intersection of the three.
// Its ends are found exactly: start from the estimate -r/a - 0.5, clamped
// to the tile, and step to the neighbour while the exact rounded
// expression says the boundary lies beyond it.  Monotonicity makes the
// walk end at the boundary, in a step or two for any estimate within a
// pixel; the walk is bounded by the tile's width whatever the estimate.
// tests/test_torch_raster.py::test_span_search_matches_dense_coverage holds
// a float32 mirror of this search to the dense coverage, bit for bit.
//
// Layout of the work:
//   * one block per (batch element, 8-row strip, x-tile of kTileW columns);
//     the tile's keys live in shared memory, start at the background key
//     and are written to device memory once, coalesced, at the end (the
//     ragged image edge is masked there);
//   * the block lists the 128-face chunks whose [lo, hi) row band overlaps
//     its strip and walks only those; a chunk's planes (6,144 B, plus 512 B
//     of attributes for the packed kernel) come through a two-slot ring in
//     shared memory, filled by the bulk copy engine (cp.async.bulk, TMA's
//     1-D copy) completing on an mbarrier, so the next chunk's copy is in
//     flight while the block works on the current one (12-14% faster than
//     staging with plain loads and a __syncthreads(), PERF.md);
//   * one warp per pixel row; a row outside the chunk's band is skipped
//     (the test is uniform across the warp); each lane takes four faces of
//     the chunk, computes the three edge row terms and the depth row term
//     once, finds the face's covered span in the row, and for each pixel of
//     it evaluates the depth and applies a shared-memory atomic minimum.
//     A minimum does not depend on the order, so the outputs are
//     deterministic.
// So the work per (row, face) pair is a few dozen instructions, and only
// covered pixels are touched, where the per-pixel form evaluated every
// pixel-face pair of every overlapping (strip, chunk).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace span_raster {

constexpr int kChunk = 128;        // faces per chunk (the bounds' chunk size)
constexpr int kCols = 12;          // plane coefficients per face
constexpr int kStripRows = 8;      // pixel rows per block, one warp each
constexpr int kTileW = 256;        // columns per block
constexpr int kThreads = 32 * kStripRows;
constexpr uint32_t kPlaneBytes = kChunk * kCols * sizeof(float);

// `b*py + c`, the part of a plane that a pixel row shares.
__device__ __forceinline__ float row_term(float b, float c, float py) {
  return __fadd_rn(__fmul_rn(b, py), c);
}

// `a*px + r` at the centre of pixel column x.
__device__ __forceinline__ float plane_at(float a, float r, int x) {
  return __fadd_rn(__fmul_rn(a, static_cast<float>(x) + 0.5f), r);
}

__device__ __forceinline__ bool passes(float a, float r, int x) {
  return plane_at(a, r, x) >= 0.0f;     // false for NaN
}

// Narrow the pixel span [k, m) of a row to the pixels that pass the edge
// (a, r).  The estimate only picks where the exact walk starts.
__device__ __forceinline__ void clip_edge(float a, float r, int& k, int& m) {
  if (a > 0.0f && r == r) {              // a suffix: find its first pixel
    const float est = ceilf(__fdividef(-r, a) - 0.5f);
    int s = static_cast<int>(fminf(fmaxf(est, static_cast<float>(k)), static_cast<float>(m)));
    while (s > k && passes(a, r, s - 1)) --s;
    while (s < m && !passes(a, r, s)) ++s;
    k = s;
  } else if (a < 0.0f && r == r) {       // a prefix: find one past its last pixel
    const float est = floorf(__fdividef(-r, a) - 0.5f) + 1.0f;
    int s = static_cast<int>(fminf(fmaxf(est, static_cast<float>(k)), static_cast<float>(m)));
    while (s < m && passes(a, r, s)) ++s;
    while (s > k && !passes(a, r, s - 1)) --s;
    m = s;
  } else if (!(a == 0.0f && r >= 0.0f)) {  // a NaN, r NaN, or a == 0 with r < 0
    m = k;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(1u) : "memory");
}

// Thread 0 arrives once and announces the bytes the copies will deliver;
// the phase completes when they have landed.
__device__ __forceinline__ void barrier_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_addr(bar))
      : "memory");
}

// Keys: the policy of one kernel file.
//   using Key;                  int32_t or unsigned long long (shared atomicMin)
//   static constexpr bool kHasAttr;   stage the per-face int32 attributes too
//   Key background() const;
//   void visit(Key* slot, float z, int face, int attr) const;   covered pixel
//   void store(size_t pixel, Key key) const;                    the output
template <class Keys>
__global__ void __launch_bounds__(kThreads)
span_raster_kernel(const int32_t* __restrict__ bounds, const float* __restrict__ planes,
                   const int32_t* __restrict__ attr, int num_chunks, int img_h, int img_w,
                   Keys keys) {
  using Key = typename Keys::Key;
  constexpr uint32_t kAttrBytes = Keys::kHasAttr ? kChunk * sizeof(int32_t) : 0;
  __shared__ __align__(16) float s_planes[2][kChunk * kCols];
  __shared__ __align__(16) int32_t s_attr[Keys::kHasAttr ? 2 : 1][kChunk];
  __shared__ __align__(16) Key s_key[kStripRows][kTileW];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_chunk[kThreads], s_lo[kThreads], s_hi[kThreads];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kStripRows;
  const int x0 = blockIdx.x * kTileW;
  const int x1 = min(x0 + kTileW, img_w);
  const int y = y0 + warp;                 // this warp's pixel row
  const float py = static_cast<float>(y) + 0.5f;
  const int32_t* bb = bounds + static_cast<size_t>(b) * num_chunks * 2;
  const float* pb = planes + static_cast<size_t>(b) * num_chunks * kChunk * kCols;

  const Key bg = keys.background();
  for (int i = tid; i < kStripRows * kTileW; i += kThreads) (&s_key[0][0])[i] = bg;
  if (tid == 0) {
    barrier_init(&s_bar[0]);
    barrier_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 fills a slot of the ring with list entry i's chunk.
  auto stage = [&](int slot, int i) {
    const int c = s_chunk[i];
    barrier_expect_bytes(&s_bar[slot], kPlaneBytes + kAttrBytes);
    bulk_load(s_planes[slot], pb + static_cast<size_t>(c) * kChunk * kCols, kPlaneBytes,
              &s_bar[slot]);
    if (Keys::kHasAttr)
      bulk_load(s_attr[slot], attr + static_cast<size_t>(c) * kChunk, kAttrBytes, &s_bar[slot]);
  };

  uint32_t parity = 0;                     // bit s: the parity slot s completes next
  for (int base = 0; base < num_chunks; base += kThreads) {
    // The chunks of [base, base + kThreads) whose band overlaps the strip.
    if (tid == 0) s_count = 0;
    __syncthreads();
    const int c = base + tid;
    int lo = 0, hi = 0;
    if (c < num_chunks) {
      lo = bb[2 * c];
      hi = bb[2 * c + 1];
    }
    const bool hit = c < num_chunks && lo < hi && lo < y0 + kStripRows && hi > y0;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&s_count, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (hit) {
      s_chunk[at] = c;
      s_lo[at] = lo;
      s_hi[at] = hi;
    }
    __syncthreads();
    const int n = s_count;
    if (tid == 0) {
      for (int i = 0; i < min(n, 2); ++i) stage(i, i);
    }

    for (int i = 0; i < n; ++i) {
      const int slot = i & 1;
      barrier_wait(&s_bar[slot], (parity >> slot) & 1u);
      parity ^= 1u << slot;
      if (y >= s_lo[i] && y < s_hi[i] && y < img_h) {   // uniform across the warp
        const float4* sp = reinterpret_cast<const float4*>(s_planes[slot]);
        const int face0 = s_chunk[i] * kChunk;
        Key* row = s_key[warp];
#pragma unroll 1
        for (int f = lane; f < kChunk; f += 32) {
          const float4 p0 = sp[3 * f];       // e0x e0y e0c e1x
          const float4 p1 = sp[3 * f + 1];   // e1y e1c e2x e2y
          const float4 p2 = sp[3 * f + 2];   // e2c zx  zy  zc
          int k = x0, m = x1;
          clip_edge(p0.x, row_term(p0.y, p0.z, py), k, m);
          if (k < m) clip_edge(p0.w, row_term(p1.x, p1.y, py), k, m);
          if (k < m) clip_edge(p1.z, row_term(p1.w, p2.x, py), k, m);
          if (k < m) {
            const float rz = row_term(p2.z, p2.w, py);
            const int a = Keys::kHasAttr ? s_attr[slot][f] : 0;
            for (int x = k; x < m; ++x) keys.visit(&row[x - x0], plane_at(p2.y, rz, x), face0 + f, a);
          }
        }
      }
      __syncthreads();                    // every warp is done with this slot
      if (tid == 0 && i + 2 < n) stage(slot, i + 2);
    }
    __syncthreads();                      // the list is rewritten next round
  }

  for (int i = tid; i < kStripRows * kTileW; i += kThreads) {
    const int yy = y0 + i / kTileW, xx = x0 + i % kTileW;
    if (yy < img_h && xx < img_w) {
      keys.store((static_cast<size_t>(b) * img_h + yy) * img_w + xx, (&s_key[0][0])[i]);
    }
  }
}

// Launch over the whole batch on `stream`; returns cudaGetLastError().
template <class Keys>
int launch_span_raster(const int32_t* bounds, const float* planes, const int32_t* attr,
                       int batch, int num_chunks, int img_h, int img_w, Keys keys,
                       void* stream) {
  if (batch == 0 || img_h == 0 || img_w == 0) return 0;
  const dim3 grid((img_w + kTileW - 1) / kTileW, (img_h + kStripRows - 1) / kStripRows, batch);
  span_raster_kernel<Keys><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bounds, planes, attr, num_chunks, img_h, img_w, keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace span_raster
