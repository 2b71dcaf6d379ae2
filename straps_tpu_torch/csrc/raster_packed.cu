// Attribute-packed triangle rasteriser for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel_packed` of
// straps_tpu/render/pallas_raster.py (launched by `rasterize_pallas` with
// `face_attr`).  Same function: for every pixel centre (x + 0.5, y + 0.5)
// and every face, evaluate three edge planes and one depth plane
// `a*x + (b*y + c)`; the pixel is covered when all three edges are >= 0.
// The covered face's depth bits with the low ATTR_BITS mantissa bits
// replaced by the face's attribute (body-part id) form an int32 key, and
// the pixel keeps the minimum key.  Positive floats order like their bit
// patterns, so one integer min resolves the depth test and the attribute
// lookup together.
//
// What bounds it on this card: operations, not bytes.  Each input byte is
// read once (planes, bounds, attributes) and each output int written once,
// some 60 MB for a batch of 64 SMPL meshes at 256x256, which is ~18 us of
// HBM time; the edge planes over the (8-row strip, face chunk) pairs that
// overlap need 6 FP32 operations per pixel and face (`a*x` and a sum per
// edge; `b*y + c` depends only on the row and the face), and the depth
// plane 4 more where the pixel is covered, some 3e10 for the same batch.
// With FMA forbidden (below) each is one instruction, at half the 67
// TFLOP/s data-sheet rate: ~1 ms.
//
// What the design does about it:
//   * one thread per pixel of a 32 x 8 tile, one warp per pixel row, so a
//     warp shares y and each face's coefficients are a shared-memory
//     broadcast;
//   * the block skips every 128-face chunk whose [lo, hi) row band misses
//     its 8 rows (the test is uniform across the block, so no divergence),
//     which leaves only the chunks that can cover the tile;
//   * a chunk's planes (128 x 12 floats) and attributes are staged in shared
//     memory once and read by all 256 threads;
//   * the running key lives in a register and is written once.
// Blocks are independent: the TPU kernel's sequential grid over strips
// becomes a parallel grid, and its loop over chunks a loop inside the block.
//
// The plane evaluation rounds each product and sum separately
// (__fmul_rn / __fadd_rn), in the order of the plain PyTorch version, so
// that edge pixels agree with it exactly: a fused multiply-add would round
// once and move pixels whose edge value is within an ulp of zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;        // faces per chunk (the bounds' chunk size)
constexpr int kCols = 12;          // plane coefficients per face
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kAttrMask = 7;       // (1 << ATTR_BITS) - 1

__global__ void __launch_bounds__(kTileW * kTileH)
raster_packed_kernel(const int32_t* __restrict__ bounds,
                     const float* __restrict__ planes,
                     const int32_t* __restrict__ attr,
                     int32_t* __restrict__ out,
                     int num_chunks, int img_h, int img_w, int32_t init_key) {
  __shared__ __align__(16) float s_planes[kChunk * kCols];
  __shared__ int32_t s_attr[kChunk];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int32_t* bb = bounds + static_cast<size_t>(b) * num_chunks * 2;
  const float* pb = planes + static_cast<size_t>(b) * num_chunks * kChunk * kCols;
  int32_t best = init_key;

  for (int c = 0; c < num_chunks; ++c) {
    const int lo = bb[2 * c];
    const int hi = bb[2 * c + 1];
    if (!(lo < y0 + kTileH && hi > y0)) continue;   // block-uniform skip

    __syncthreads();   // every thread is done with the previous chunk
    const float4* src = reinterpret_cast<const float4*>(pb + static_cast<size_t>(c) * kChunk * kCols);
    float4* dst = reinterpret_cast<float4*>(s_planes);
    for (int i = tid; i < kChunk * kCols / 4; i += kTileW * kTileH) dst[i] = src[i];
    for (int i = tid; i < kChunk; i += kTileW * kTileH) s_attr[i] = attr[c * kChunk + i];
    __syncthreads();

    const float4* sp = reinterpret_cast<const float4*>(s_planes);
#pragma unroll 4
    for (int f = 0; f < kChunk; ++f) {
      const float4 p0 = sp[3 * f];       // e0x e0y e0c e1x
      const float4 p1 = sp[3 * f + 1];   // e1y e1c e2x e2y
      const float4 p2 = sp[3 * f + 2];   // e2c zx  zy  zc
      const float e0 = __fadd_rn(__fmul_rn(p0.x, px), __fadd_rn(__fmul_rn(p0.y, py), p0.z));
      const float e1 = __fadd_rn(__fmul_rn(p0.w, px), __fadd_rn(__fmul_rn(p1.x, py), p1.y));
      const float e2 = __fadd_rn(__fmul_rn(p1.z, px), __fadd_rn(__fmul_rn(p1.w, py), p2.x));
      // All three >= 0, false for NaN: the NaN-propagating min of the
      // reference followed by `>= 0`.
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
        const float z = __fadd_rn(__fmul_rn(p2.y, px), __fadd_rn(__fmul_rn(p2.z, py), p2.w));
        const int32_t key = (__float_as_int(z) & ~kAttrMask) | s_attr[f];
        best = min(best, key);
      }
    }
  }
  if (x < img_w && y < img_h) {
    out[(static_cast<size_t>(b) * img_h + y) * img_w + x] = best;
  }
}

}  // namespace

// planes: (B, num_chunks * 128, 12) f32; bounds: (B, num_chunks, 2) int32;
// attr: (num_chunks * 128,) int32 in [0, 8); out: (B, img_h, img_w) int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int raster_packed_launch(const int32_t* bounds, const float* planes,
                                    const int32_t* attr, int32_t* out,
                                    int batch, int num_chunks, int img_h,
                                    int img_w, int32_t init_key,
                                    void* stream) {
  if (batch == 0 || img_h == 0 || img_w == 0) return 0;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((img_w + kTileW - 1) / kTileW, (img_h + kTileH - 1) / kTileH, batch);
  raster_packed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      bounds, planes, attr, out, num_chunks, img_h, img_w, init_key);
  return static_cast<int>(cudaGetLastError());
}
