"""Batch renderer: vertices + camera -> body-part map, silhouette, face-id
map or flat-shaded RGB.

Counterpart of `straps_tpu/render/renderer.py`.  The rasterisers follow
the tensors' device: on CUDA the kernels, on the CPU their plain versions
(`rasterize_packed` for part maps and silhouettes, `rasterize_faceid` for
face ids and RGB).
"""

from typing import Optional, Tuple

import torch

from straps_tpu_torch.render.cuda_raster import (
    FACE_CHUNK, rasterize_faceid, rasterize_packed,
)
from straps_tpu_torch.render.raster import (
    backface_mask, face_chunk_row_bounds, kill_faces, prepare_face_planes,
    project_to_screen,
)


@torch.no_grad()
def render_part_seg(verts: torch.Tensor, cam_t: torch.Tensor,
                    cam_K: torch.Tensor, faces: torch.Tensor,
                    face_parts: torch.Tensor, img_wh: int,
                    cam_R: Optional[torch.Tensor] = None,
                    cull_backfaces: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of meshes to part-id maps.

    Args:
      verts: (B, V, 3) model-space vertices; cam_t: (B, 3); cam_K: (3, 3).
      faces: (F, 3) int; face_parts: (F,) int part id per face in [0, 8).
      img_wh: square output size (any size: the kernel masks ragged edges).
      cull_backfaces: kill back faces and drop them from the chunk row
        bounds; the same output on a watertight mesh, fewer chunks to scan.
    Returns:
      parts (B, img_wh, img_wh) int32 (0 = background) and depth
      (B, img_wh, img_wh) f32 (3.4e38 where background).
    """
    planes, bounds = part_seg_planes(verts, cam_t, cam_K, faces, img_wh, cam_R,
                                     cull_backfaces)
    return rasterize_packed(planes, bounds, face_parts, img_wh, img_wh)


def part_seg_planes(verts: torch.Tensor, cam_t: torch.Tensor, cam_K: torch.Tensor,
                    faces: torch.Tensor, img_wh: int, cam_R: Optional[torch.Tensor] = None,
                    cull_backfaces: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plane-form faces (B, F, 4, 3) and chunk row bounds that
    `render_part_seg` rasterises, with its arguments."""
    screen, z = project_to_screen(verts, cam_t, cam_K, cam_R)
    planes = prepare_face_planes(screen, z, faces)
    dead = None
    if cull_backfaces:
        dead = backface_mask(screen, faces)
        planes = kill_faces(planes, dead)
    bounds = face_chunk_row_bounds(screen, faces, FACE_CHUNK, img_wh,
                                   dead_mask=dead)
    return planes, bounds


def render_silhouette(verts, cam_t, cam_K, faces, img_wh, cam_R=None,
                      cull_backfaces=False):
    """Binary silhouette (f32, part map != 0) and depth."""
    ones = torch.ones((faces.shape[0],), dtype=torch.int32, device=faces.device)
    parts, depth = render_part_seg(verts, cam_t, cam_K, faces, ones, img_wh,
                                   cam_R=cam_R, cull_backfaces=cull_backfaces)
    return (parts > 0).to(torch.float32), depth


@torch.no_grad()
def render_face_ids(verts: torch.Tensor, cam_t: torch.Tensor,
                    cam_K: torch.Tensor, faces: torch.Tensor, img_wh: int,
                    cam_R: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of meshes, unculled, to face-id maps (B, img_wh,
    img_wh) int32 (-1 = background) and exact depth f32 (3.4e38 where
    background)."""
    screen, z = project_to_screen(verts, cam_t, cam_K, cam_R)
    planes = prepare_face_planes(screen, z, faces)
    bounds = face_chunk_row_bounds(screen, faces, FACE_CHUNK, img_wh)
    return rasterize_faceid(planes, bounds, img_wh, img_wh)


def render_rgb(verts: torch.Tensor, cam_t: torch.Tensor, cam_K: torch.Tensor,
               faces: torch.Tensor, face_colors: torch.Tensor, img_wh: int,
               cam_R: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-shaded RGB render + depth.

    Args:
      face_colors: (F, 3) per-face RGB in [0, 1].
    Returns:
      rgb (B, H, W, 3) with background black, depth (B, H, W).
    """
    fid, depth = render_face_ids(verts, cam_t, cam_K, faces, img_wh, cam_R)
    return face_colors[fid.clamp(min=0).long()] * (fid >= 0)[..., None], depth
