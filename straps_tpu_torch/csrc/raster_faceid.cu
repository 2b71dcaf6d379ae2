// Face-id triangle rasteriser for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel` of
// straps_tpu/render/pallas_raster.py (launched by `rasterize_pallas`
// without `face_attr`).  Same function: for every pixel centre
// (x + 0.5, y + 0.5) and every face, evaluate three edge planes
// `a*x + (b*y + c)`; the pixel is covered when all three are >= 0.  Among
// the covered faces the pixel keeps the one of least depth (the depth
// plane, evaluated the same way), and on a depth tie the smallest face id.
// Outputs: the face id (-1 where background) and the exact f32 depth
// (3.4e38 where background).
//
// The TPU kernel takes, within a 128-face chunk, the row min and its first
// argmin, and across chunks updates on a strict `<`.  That is the
// lexicographic minimum of (depth, face id).  Here one thread owns one
// pixel and visits the faces in increasing id, updating on a strict
// `z < best_z`: the first face to reach the least depth keeps it, which is
// the same minimum.
//
// What bounds it on this card: operations, not bytes.  Each input byte is
// read once (planes, bounds) and each output written once (4 + 4 bytes a
// pixel), some 80 MB for a batch of 64 SMPL meshes at 256x256, ~25 us of
// HBM time; the edge planes of the (8-row strip, face chunk) pairs that
// overlap need 6 FP32 operations per pixel and face (`a*x` and a sum per
// edge; `b*y + c` depends only on the row and the face), and the depth
// plane 4 more where the pixel is covered, some 3e10 operations for the
// same batch unculled.  With FMA forbidden (below) each is one
// instruction, at half the 67 TFLOP/s data-sheet rate: ~0.8 ms.  The
// kernel below computes `b*y + c` at every pixel, 12 operations per pixel
// and face, twice what the bound charges.
//
// What the design does about it:
//   * one thread per pixel of a 32 x 8 tile, one warp per pixel row, so a
//     warp shares y and each face's coefficients are a shared-memory
//     broadcast;
//   * the block skips every 128-face chunk whose [lo, hi) row band misses
//     its 8 rows (the test is uniform across the block, so no divergence);
//   * a chunk's planes (128 x 12 floats) are staged in shared memory once
//     and read by all 256 threads;
//   * the running (depth, face id) pair lives in registers and each output
//     is written once; the ragged image edge is masked at the store.
// Blocks are independent: the TPU kernel's sequential grid over strips
// becomes a parallel grid, and its loop over chunks a loop inside the block.
//
// The plane evaluation rounds each product and sum separately
// (__fmul_rn / __fadd_rn), in the order of the plain PyTorch version, so
// that edge pixels agree with it exactly: nvcc would otherwise contract
// a multiply and an add into one fused operation rounded once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;        // faces per chunk (the bounds' chunk size)
constexpr int kCols = 12;          // plane coefficients per face
constexpr int kTileW = 32;
constexpr int kTileH = 8;

__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__global__ void __launch_bounds__(kTileW * kTileH)
raster_faceid_kernel(const int32_t* __restrict__ bounds,
                     const float* __restrict__ planes,
                     int32_t* __restrict__ fid_out,
                     float* __restrict__ z_out,
                     int num_chunks, int img_h, int img_w, float bg_depth) {
  __shared__ __align__(16) float s_planes[kChunk * kCols];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int32_t* bb = bounds + static_cast<size_t>(b) * num_chunks * 2;
  const float* pb = planes + static_cast<size_t>(b) * num_chunks * kChunk * kCols;
  float best_z = bg_depth;
  int32_t best_f = -1;

  for (int c = 0; c < num_chunks; ++c) {
    const int lo = bb[2 * c];
    const int hi = bb[2 * c + 1];
    if (!(lo < y0 + kTileH && hi > y0)) continue;   // block-uniform skip

    __syncthreads();   // every thread is done with the previous chunk
    const float4* src = reinterpret_cast<const float4*>(pb + static_cast<size_t>(c) * kChunk * kCols);
    float4* dst = reinterpret_cast<float4*>(s_planes);
    for (int i = tid; i < kChunk * kCols / 4; i += kTileW * kTileH) dst[i] = src[i];
    __syncthreads();

    const float4* sp = reinterpret_cast<const float4*>(s_planes);
#pragma unroll 4
    for (int f = 0; f < kChunk; ++f) {
      const float4 p0 = sp[3 * f];       // e0x e0y e0c e1x
      const float4 p1 = sp[3 * f + 1];   // e1y e1c e2x e2y
      const float4 p2 = sp[3 * f + 2];   // e2c zx  zy  zc
      const float e0 = plane(p0.x, p0.y, p0.z, px, py);
      const float e1 = plane(p0.w, p1.x, p1.y, px, py);
      const float e2 = plane(p1.z, p1.w, p2.x, px, py);
      // All three >= 0, false for NaN: the NaN-propagating min of the
      // reference followed by `>= 0`.
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
        const float z = plane(p2.y, p2.z, p2.w, px, py);
        if (z < best_z) {          // strict: the smaller id keeps a tie
          best_z = z;
          best_f = c * kChunk + f;
        }
      }
    }
  }
  if (x < img_w && y < img_h) {
    const size_t o = (static_cast<size_t>(b) * img_h + y) * img_w + x;
    fid_out[o] = best_f;
    z_out[o] = best_z;
  }
}

}  // namespace

// planes: (B, num_chunks * 128, 12) f32; bounds: (B, num_chunks, 2) int32;
// fid_out: (B, img_h, img_w) int32; z_out: (B, img_h, img_w) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int raster_faceid_launch(const int32_t* bounds, const float* planes,
                                    int32_t* fid_out, float* z_out,
                                    int batch, int num_chunks, int img_h,
                                    int img_w, float bg_depth, void* stream) {
  if (batch == 0 || img_h == 0 || img_w == 0) return 0;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((img_w + kTileW - 1) / kTileW, (img_h + kTileH - 1) / kTileH, batch);
  raster_faceid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      bounds, planes, fid_out, z_out, num_chunks, img_h, img_w, bg_depth);
  return static_cast<int>(cudaGetLastError());
}
