"""Hot-path kernels and native ops, gathered under one surface
(counterpart of `straps_tpu/ops/__init__.py`).

The implementations live with their subsystems; this package is the
kernel inventory.  The JAX package's names and the port's:

| `straps_tpu.ops` | `straps_tpu_torch` |
|---|---|
| `rasterize_pallas` (the two Pallas kernels) | `render/cuda_raster.py::rasterize_packed`, `rasterize_faceid` (hand-written CUDA C++ for sm_90a, `csrc/raster_packed.cu`, `csrc/raster_faceid.cu`); their plain versions `rasterize_packed_reference`, `rasterize_faceid_reference` |
| `FACE_CHUNK` | `render/cuda_raster.py::FACE_CHUNK` |
| `rasterize_xla`, `prepare_face_planes` | `render/raster.py` |
| `soft_silhouette` | `render/soft_silhouette.py` |
| `nms_fixed`, `roi_align`, `multilevel_roi_align`, `bilinear_sample`, `pairwise_iou`, `encode_boxes`, `decode_boxes` | `perception/ops.py` |
| `load_npy_batch`, `shuffled_indices`, `mmap_npy` | `data/native_io.py` over `csrc/straps_io.cpp` |

`JAX_COUNTERPARTS` holds the same table.  Importing this package builds
nothing: the CUDA kernels build at their first launch on a card, the host
C++ at its first call.
"""

from straps_tpu_torch.data.native_io import load_npy_batch, mmap_npy, shuffled_indices
from straps_tpu_torch.perception.ops import (
    bilinear_sample, decode_boxes, encode_boxes, multilevel_roi_align, nms_fixed, pairwise_iou,
    roi_align,
)
from straps_tpu_torch.render.cuda_raster import (
    FACE_CHUNK, rasterize_faceid, rasterize_faceid_reference, rasterize_packed,
    rasterize_packed_reference,
)
from straps_tpu_torch.render.raster import prepare_face_planes, rasterize_xla
from straps_tpu_torch.render.soft_silhouette import soft_silhouette

__all__ = [
    "rasterize_packed", "rasterize_faceid", "rasterize_packed_reference",
    "rasterize_faceid_reference", "FACE_CHUNK", "rasterize_xla", "prepare_face_planes",
    "soft_silhouette", "nms_fixed", "roi_align", "multilevel_roi_align",
    "bilinear_sample", "pairwise_iou", "encode_boxes", "decode_boxes",
    "load_npy_batch", "shuffled_indices", "mmap_npy",
]

# Each name of `straps_tpu.ops.__all__` -> its counterparts in `__all__`.
JAX_COUNTERPARTS = {
    "rasterize_pallas": ("rasterize_packed", "rasterize_faceid", "rasterize_packed_reference",
                         "rasterize_faceid_reference"),
    **{name: (name,) for name in __all__[4:]},
}
