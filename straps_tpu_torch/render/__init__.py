"""Rasterisation and rendering (counterpart of `straps_tpu/render/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.render.__all__` to its
counterparts here.  The TPU kernels of `rasterize_pallas` are the CUDA
kernels behind `rasterize_packed` and `rasterize_faceid`
(`cuda_raster.py`), each with its plain version beside it.  Importing
this package builds nothing: the kernels build at their first launch.
"""

from straps_tpu_torch.render.cuda_raster import (
    FACE_CHUNK, rasterize_faceid, rasterize_faceid_reference, rasterize_packed,
    rasterize_packed_reference,
)
from straps_tpu_torch.render.raster import (
    face_chunk_row_bounds, face_ids_to_parts, prepare_face_planes, project_to_screen,
    rasterize_xla,
)
from straps_tpu_torch.render.renderer import render_part_seg, render_rgb, render_silhouette

__all__ = [
    "project_to_screen", "prepare_face_planes", "face_chunk_row_bounds", "rasterize_xla",
    "face_ids_to_parts", "rasterize_packed", "rasterize_faceid", "rasterize_packed_reference",
    "rasterize_faceid_reference", "FACE_CHUNK", "render_part_seg", "render_silhouette",
    "render_rgb",
]

_KERNELS = ("rasterize_packed", "rasterize_faceid", "rasterize_packed_reference",
            "rasterize_faceid_reference")

JAX_COUNTERPARTS = {
    **{name: (name,) for name in __all__ if name not in _KERNELS},
    "rasterize_pallas": _KERNELS,
    "default_raster_backend": "the tensors' device picks the rasteriser: the CUDA kernel "
                              "on the card, its plain version on the CPU",
}
