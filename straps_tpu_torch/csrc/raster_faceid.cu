// Face-id triangle rasteriser for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel` of
// straps_tpu/render/pallas_raster.py (launched by `rasterize_pallas`
// without `face_attr`).  Same function: per pixel centre, among the faces
// that cover it, the one of least depth, and on a depth tie the smallest
// face id.  Outputs: the face id (-1 where background) and the exact f32
// depth (3.4e38 where background).  The TPU kernel takes, within a 128-face
// chunk, the row min and its first argmin, and across chunks updates on a
// strict `<`: the lexicographic minimum of (depth, face id).
//
// The design is the per-row span scan of raster_span.cuh.  A covered pixel
// whose depth is below the background's (`z < 3.4e38`, false for NaN)
// enters the tile's shared-memory keys by `atomicMin(unsigned long long*)`
// on the 64-bit key (order(z) << 32) | face id, where order(z) maps the
// float's bits to an unsigned integer of the same order (all bits flipped
// for a negative, the sign bit set for a positive).  So the minimum key is
// the (depth, smallest id) minimum of `rasterize_faceid_reference`, whatever
// the order of the atomics, and the depth decodes from it exactly.  One
// departure: -0.0 orders below +0.0, where the plain version calls them a
// tie; no face reaches it, since a face with a vertex at depth <= 1e-6 is
// killed (render/raster.py::prepare_face_planes).  The span search is held
// to the dense coverage by
// tests/test_torch_raster.py::test_span_search_matches_dense_coverage.
//
// What bounds it on this card: bytes.  Each input byte is read once (planes,
// bounds) and each output written once (4 + 4 bytes a pixel), ~76 MB for a
// batch of 64 SMPL meshes at 256x256, ~23 us of HBM time; the work is 6
// unfused FP32 operations per (row, face) pair inside each chunk's band
// and 4 per covered pixel, ~0.1e9 for the same batch, ~3 us.
//
// No tensor cores: the outputs must match the plain version bit for bit, so
// each product and each sum is rounded on its own (nvcc would otherwise
// contract a multiply and an add into one fused operation rounded once),
// and no tensor-core path rounds that way; the work is a handful of scalar
// operations per (row, face) pair in any case.

#include "raster_span.cuh"

namespace {

__device__ __forceinline__ uint32_t order_bits(float z) {
  const uint32_t u = __float_as_uint(z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_to_float(uint32_t m) {
  return __uint_as_float((m & 0x80000000u) ? (m ^ 0x80000000u) : ~m);
}

struct FaceIdKeys {
  using Key = unsigned long long;
  static constexpr bool kHasAttr = false;
  float bg_depth;
  int32_t* fid_out;
  float* z_out;

  __device__ Key background() const {     // (bg_depth, -1)
    return (static_cast<Key>(order_bits(bg_depth)) << 32) | 0xffffffffull;
  }
  __device__ void visit(Key* slot, float z, int face, int) const {
    if (z < bg_depth) {
      atomicMin(slot, (static_cast<Key>(order_bits(z)) << 32) | static_cast<uint32_t>(face));
    }
  }
  __device__ void store(size_t pixel, Key key) const {
    fid_out[pixel] = static_cast<int32_t>(static_cast<uint32_t>(key));
    z_out[pixel] = order_to_float(static_cast<uint32_t>(key >> 32));
  }
};

}  // namespace

// planes: (B, num_chunks * 128, 12) f32, 16-byte aligned; bounds:
// (B, num_chunks, 2) int32; fid_out: (B, img_h, img_w) int32; z_out:
// (B, img_h, img_w) f32.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int raster_faceid_launch(const int32_t* bounds, const float* planes,
                                    int32_t* fid_out, float* z_out,
                                    int batch, int num_chunks, int img_h,
                                    int img_w, float bg_depth, void* stream) {
  return span_raster::launch_span_raster(bounds, planes, nullptr, batch, num_chunks, img_h,
                                         img_w, FaceIdKeys{bg_depth, fid_out, z_out}, stream);
}
