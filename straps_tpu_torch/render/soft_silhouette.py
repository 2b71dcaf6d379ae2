"""Differentiable soft silhouette: a vertex splat (counterpart of
`straps_tpu/render/soft_silhouette.py`).

Each projected vertex is splatted as a separable Gaussian onto a coarse
grid; the splats' sum goes through a saturating exponential, so the
coverage field lies in [0, 1) and overlapping splats do not overshoot.
The optional 'silhouette' task of the train step supervises it against the
proxy's silhouette resized to the grid.  Float32 throughout: the vertex
contraction is one batched matrix product outside autocast (TF32 is off on
the card, `utils/device.py`).
"""

import math

import torch

from straps_tpu_torch.geometry.camera import orthographic_project
from straps_tpu_torch.geometry.joints import undo_keypoint_normalisation


def soft_silhouette(verts2d: torch.Tensor, img_wh: int, sigma: float = 0.8,
                    sharpness: float = 2.0) -> torch.Tensor:
    """(B, V, 2) pixel-space vertices -> (B, img_wh, img_wh) coverage,
    `1 - exp(-sharpness * sum_v g_v / (2 pi sigma^2))` with `g_v` the
    vertex's Gaussian of `sigma` px at the pixel centres (`arange + 0.5`)."""
    with torch.autocast(device_type=verts2d.device.type, enabled=False):
        verts2d = verts2d.float()
        xs = torch.arange(img_wh, dtype=torch.float32, device=verts2d.device) + 0.5
        # Separable: (B, V, W) along x and (B, V, H) along y.
        dx = xs - verts2d[..., 0:1]
        dy = xs - verts2d[..., 1:2]
        gx = torch.exp(-(dx * dx) / (2.0 * sigma * sigma))
        gy = torch.exp(-(dy * dy) / (2.0 * sigma * sigma))
        # sum_v gy[v, h] * gx[v, w]: one (H, V) x (V, W) product per body.
        acc = torch.bmm(gy.transpose(1, 2), gx)
        return 1.0 - torch.exp(-sharpness * acc / (2.0 * math.pi * sigma * sigma))


def soft_silhouette_from_wp(verts: torch.Tensor, cam_wp: torch.Tensor, img_wh: int,
                            sigma: float = 0.8, sharpness: float = 2.0) -> torch.Tensor:
    """The soft silhouette of 3D vertices (B, V, 3) under a weak-perspective
    camera (B, 3), on an `img_wh` grid: the differentiable path from the
    predicted mesh."""
    v2d = undo_keypoint_normalisation(orthographic_project(verts, cam_wp), img_wh)
    return soft_silhouette(v2d, img_wh, sigma=sigma, sharpness=sharpness)
