"""Mesh -> plane-form faces, chunk row bounds and the plain face-id rasteriser.

PyTorch counterpart of `straps_tpu/render/raster.py`.  Rasterisation is the
evaluation of per-face affine plane functions (three edges and one depth
plane, each `a*x + b*y + c`) at pixel centres, with a min-depth reduction.
This module prepares those planes and the per-chunk row bounds that let a
rasteriser skip face chunks; `straps_tpu_torch.render.cuda_raster` holds the
attribute-packed rasteriser (a CUDA kernel and its plain version).

No gradients: the renders are targets and metrics, never differentiated.
"""

from typing import Optional, Tuple

import torch

from straps_tpu_torch.utils.device import device_constant


def project_to_screen(verts: torch.Tensor, cam_t: torch.Tensor,
                      cam_K: torch.Tensor,
                      cam_R: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`p = R v + t`, pixel = K-normalised.

    Args:
      verts: (B, V, 3); cam_t: (B, 3); cam_K: (3, 3); cam_R: optional (3, 3).
    Returns:
      screen_xy (B, V, 2) pixel coordinates and depth (B, V) view z.
    """
    if cam_R is not None:
        verts = torch.einsum("ij,bvj->bvi", cam_R, verts)
    p = verts + cam_t[:, None, :]
    z = p[..., 2]
    fx, fy = cam_K[0, 0], cam_K[1, 1]
    cx, cy = cam_K[0, 2], cam_K[1, 2]
    x = fx * p[..., 0] / z + cx
    y = fy * p[..., 1] / z + cy
    return torch.stack([x, y], dim=-1), z


def _kill_rows(dtype, device) -> torch.Tensor:
    """(4, 3) plane block of a never-covered face: edge constants -1."""
    kill = torch.zeros((4, 3), dtype=dtype, device=device)
    kill[:3, 2] = -1.0
    return kill


def prepare_face_planes(screen_xy: torch.Tensor, depth: torch.Tensor,
                        faces: torch.Tensor) -> torch.Tensor:
    """The four affine plane functions of every face.

    Args:
      screen_xy: (B, V, 2); depth: (B, V); faces: (F, 3) int.
    Returns:
      (B, F, 4, 3) planes: rows [edge0, edge1, edge2, depth], columns
      [coef_x, coef_y, const].  Degenerate and behind-camera faces get
      edge constants -1 (never covered).
    """
    v = screen_xy[:, faces, :]          # (B, F, 3, 2)
    z = depth[:, faces]                 # (B, F, 3)
    x0, y0 = v[..., 0, 0], v[..., 0, 1]
    x1, y1 = v[..., 1, 0], v[..., 1, 1]
    x2, y2 = v[..., 2, 0], v[..., 2, 1]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    s = torch.sign(area)

    def edge(ax, ay, bx, by):
        # Inside iff cross(b - a, p - a) has the sign of the face area.
        cx = -(by - ay) * s
        cy = (bx - ax) * s
        cc = (ax * (by - ay) - ay * (bx - ax)) * s
        return torch.stack([cx, cy, cc], dim=-1)

    e0 = edge(x0, y0, x1, y1)
    e1 = edge(x1, y1, x2, y2)
    e2 = edge(x2, y2, x0, y0)

    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    nx = (y1 - y0) * (z2 - z0) - (z1 - z0) * (y2 - y0)
    ny = (z1 - z0) * (x2 - x0) - (x1 - x0) * (z2 - z0)
    safe_nz = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
    zx = -nx / safe_nz
    zy = -ny / safe_nz
    zc = z0 - zx * x0 - zy * y0
    dplane = torch.stack([zx, zy, zc], dim=-1)

    planes = torch.stack([e0, e1, e2, dplane], dim=-2)   # (B, F, 4, 3)
    bad = (area.abs() < 1e-9) | torch.any(z <= 1e-6, dim=-1)
    return kill_faces(planes, bad)


def sort_faces_by_ymin(planes: torch.Tensor, screen_xy: torch.Tensor, faces: torch.Tensor):
    """Each batch element's faces sorted by their smallest screen y, ties
    in face order (a stable sort, as `jnp.argsort`): (sorted planes
    (B, F, 4, 3), order (B, F) int32, sorted index -> face id).  On no
    path of either package ("kept for future use"): consecutive chunks of
    sorted faces span narrow row ranges."""
    fymin = screen_xy[:, faces, 1].amin(dim=-1)                    # (B, F)
    order = torch.argsort(fymin, dim=1, stable=True)
    return torch.gather(planes, 1, order[:, :, None, None].expand_as(planes)), order.to(torch.int32)


def backface_mask(screen_xy: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, F) bool, True where the face is back-facing in screen space.

    SMPL faces wind counter-clockwise seen from outside, so under the
    y-down pixel projection a camera-facing face has positive signed area.
    On a watertight mesh the nearest face at every covered pixel faces the
    camera, so killing back faces leaves the render unchanged and lets the
    rasteriser skip chunks of back faces."""
    v = screen_xy[:, faces, :]
    x0, y0 = v[..., 0, 0], v[..., 0, 1]
    x1, y1 = v[..., 1, 0], v[..., 1, 1]
    x2, y2 = v[..., 2, 0], v[..., 2, 1]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    return area < 0.0


def kill_faces(planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Make the faces where `mask` (B, F) is True never-covered."""
    kill = _kill_rows(planes.dtype, planes.device)
    return torch.where(mask[..., None, None], kill, planes)


def face_chunk_row_bounds(screen_xy: torch.Tensor, faces: torch.Tensor,
                          chunk: int, img_h: int,
                          dead_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(B, num_chunks, 2) int32 [lo, hi) pixel-row band of each face chunk.

    A rasteriser may skip a chunk for rows outside its band.  A face that
    projects to NaN (a vertex at view z = 0) is left out of its chunk's
    band instead of poisoning it; so are the faces `dead_mask` (B, F) marks
    as killed, so that a chunk of dead faces has an empty band.
    """
    vy = screen_xy[:, faces, 1]                  # (B, F, 3)
    fymin = vy.amin(dim=-1)
    fymax = vy.amax(dim=-1)
    inf = device_constant(float("inf"), fymin.dtype, fymin.device)
    fymin = torch.where(torch.isnan(fymin), inf, fymin)
    fymax = torch.where(torch.isnan(fymax), -inf, fymax)
    if dead_mask is not None:
        fymin = torch.where(dead_mask, inf, fymin)
        fymax = torch.where(dead_mask, -inf, fymax)
    B, F = fymin.shape
    pad = (-F) % chunk
    if pad:
        fymin = torch.nn.functional.pad(fymin, (0, pad), value=float("inf"))
        fymax = torch.nn.functional.pad(fymax, (0, pad), value=float("-inf"))
    nch = (F + pad) // chunk
    cmin = fymin.reshape(B, nch, chunk).amin(dim=-1)
    cmax = fymax.reshape(B, nch, chunk).amax(dim=-1)
    lo = torch.clamp(torch.floor(cmin), 0, img_h).to(torch.int32)
    hi = torch.clamp(torch.ceil(cmax) + 1, 0, img_h).to(torch.int32)
    return torch.stack([lo, hi], dim=-1)


def pad_face_planes(planes: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad (B, F, 4, 3) planes with never-covered faces to a multiple of
    `chunk` faces."""
    B, F = planes.shape[:2]
    pad = (-F) % chunk
    if not pad:
        return planes
    kill = _kill_rows(planes.dtype, planes.device).expand(B, pad, 4, 3)
    return torch.cat([planes, kill], dim=1)


def rasterize_xla(planes: torch.Tensor, img_h: int, img_w: int,
                  chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain face-id rasteriser (the name of the JAX reference path).

    Args:
      planes: (B, F, 4, 3) from `prepare_face_planes`.
    Returns:
      face_id (B, H, W) int32, -1 where background; depth (B, H, W), +inf
      where background.  On a depth tie the smallest face id wins.
    """
    planes = pad_face_planes(planes, chunk)
    B, Fp = planes.shape[:2]
    xs = torch.arange(img_w, dtype=planes.dtype, device=planes.device) + 0.5
    ys = torch.arange(img_h, dtype=planes.dtype, device=planes.device) + 0.5
    best_z = torch.full((B, img_h, img_w), float("inf"), dtype=planes.dtype,
                        device=planes.device)
    best_f = torch.full((B, img_h, img_w), -1, dtype=torch.int32,
                        device=planes.device)
    for start in range(0, Fp, chunk):
        p = planes[:, start:start + chunk]                     # (B, C, 4, 3)
        px = p[..., 0][..., None, None] * xs
        py = p[..., 1][..., None, None] * ys[:, None]
        vals = px + py + p[..., 2][..., None, None]            # (B, C, 4, H, W)
        cov = torch.all(vals[:, :, :3] >= 0, dim=2)
        zed = torch.where(cov, vals[:, :, 3], float("inf"))
        zmin, amin = zed.min(dim=1)
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_f = torch.where(better, amin.to(torch.int32) + start, best_f)
    return best_f, best_z


def face_ids_to_parts(face_id: torch.Tensor,
                      face_parts: torch.Tensor) -> torch.Tensor:
    """Face-id map -> body-part map (0 = background)."""
    parts = face_parts[face_id.clamp(min=0).long()]
    return torch.where(face_id >= 0, parts, 0).to(torch.int32)
