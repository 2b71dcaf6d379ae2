// Attribute-packed triangle rasteriser for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel_packed` of
// straps_tpu/render/pallas_raster.py (launched by `rasterize_pallas` with
// `face_attr`).  Same function: for every pixel centre the minimum, over
// the faces that cover it, of the int32 key `(bits(z) & ~7) | attr` (the
// face's depth bits with the low ATTR_BITS mantissa bits replaced by its
// attribute, the body-part id), starting from the background key.
// Positive floats order like their bit patterns, so one integer min
// resolves the depth test and the attribute lookup together.
//
// The design is the per-row span scan of raster_span.cuh: each (row, face)
// pair finds the face's covered span exactly, and each covered pixel goes
// into the tile's shared-memory keys by `atomicMin(int*)`, which is the
// plain version's signed int32 min (render/cuda_raster.py), so the keys are
// identical whatever the order.  The span search is held to the dense
// coverage by tests/test_torch_raster.py::test_span_search_matches_dense_coverage.
//
// What bounds it on this card: bytes.  Each input byte is read once (planes,
// bounds, attributes) and each output int written once, ~59 MB for a batch
// of 64 SMPL meshes at 256x256, ~18 us of HBM time; the work is 6 unfused
// FP32 operations per (row, face) pair inside each chunk's band and 4 per
// covered pixel, ~0.1e9 for the same batch, ~3 us.
//
// No tensor cores: the key must match the plain version bit for bit, so
// each product and each sum is rounded on its own (a fused multiply-add
// would round once and move pixels whose edge value is within an ulp of
// zero), and no tensor-core path rounds that way; the work is a handful of
// scalar operations per (row, face) pair in any case.

#include "raster_span.cuh"

namespace {

constexpr int32_t kAttrMask = 7;    // (1 << ATTR_BITS) - 1

struct PackedKeys {
  using Key = int32_t;
  static constexpr bool kHasAttr = true;
  int32_t init_key;
  int32_t* out;

  __device__ Key background() const { return init_key; }
  __device__ void visit(Key* slot, float z, int, int attr) const {
    atomicMin(slot, (__float_as_int(z) & ~kAttrMask) | attr);
  }
  __device__ void store(size_t pixel, Key key) const { out[pixel] = key; }
};

}  // namespace

// planes: (B, num_chunks * 128, 12) f32; bounds: (B, num_chunks, 2) int32;
// attr: (num_chunks * 128,) int32 in [0, 8); out: (B, img_h, img_w) int32.
// planes and attr 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int raster_packed_launch(const int32_t* bounds, const float* planes,
                                    const int32_t* attr, int32_t* out,
                                    int batch, int num_chunks, int img_h,
                                    int img_w, int32_t init_key,
                                    void* stream) {
  return span_raster::launch_span_raster(bounds, planes, attr, batch, num_chunks, img_h,
                                         img_w, PackedKeys{init_key, out}, stream);
}
