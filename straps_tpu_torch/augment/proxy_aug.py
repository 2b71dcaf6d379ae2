"""Proxy-representation degradations: vertex and joint noise, body-part
removal and box occlusion (counterpart of `straps_tpu/augment/proxy_aug.py`).

Each function takes its random draws as arguments, the values of the JAX
package's `jax.random` calls (same shapes and ranges);
`draw_proxy_augment` makes all of them from a `torch.Generator`.
"""

from typing import NamedTuple, Tuple

import torch

from straps_tpu_torch import constants as C
from straps_tpu_torch.augment.draws import uniform
from straps_tpu_torch.config import ProxyAugmentConfig
from straps_tpu_torch.utils.device import device_constant


class ProxyDraws(NamedTuple):
    verts_noise: torch.Tensor     # (B, V, 2) in delta_verts2d_dev_range
    remove: torch.Tensor          # (n_classes, B) in [0, 1), one row per class
    occlude_centre: torch.Tensor  # (B, 2) rows in H/2 +- 0.15 H, cols in W/2 +- 0.15 W
    occlude: torch.Tensor         # (B,) in [0, 1)
    joints_noise: torch.Tensor    # (B, J, 2) in delta_j2d_dev_range
    hip_noise: torch.Tensor       # (B, J, 2) in delta_j2d_hip_dev_range


def occlude_centre_range(img_h: int, img_w: int):
    """Per-axis (lo, hi) of the occlusion box centre: the middle 30% of the
    image rows and of its columns."""
    lo = [img_h / 2.0 - 0.3 * img_h / 2.0, img_w / 2.0 - 0.3 * img_w / 2.0]
    hi = [img_h / 2.0 + 0.3 * img_h / 2.0, img_w / 2.0 + 0.3 * img_w / 2.0]
    return lo, hi


def draw_proxy_augment(generator: torch.Generator, batch_size: int, num_verts: int,
                       img_h: int, img_w: int, cfg: ProxyAugmentConfig, device,
                       num_joints: int = 17) -> ProxyDraws:
    """Every draw of the proxy degradations of one batch."""
    B = batch_size
    n_classes = len(cfg.remove_appendages_classes)
    verts = uniform(generator, (B, num_verts, 2), *cfg.delta_verts2d_dev_range, device)
    remove = torch.rand((n_classes, B), generator=generator, device=device)
    centre = uniform(generator, (B, 2), *occlude_centre_range(img_h, img_w), device)
    occlude = torch.rand((B,), generator=generator, device=device)
    joints = uniform(generator, (B, num_joints, 2), *cfg.delta_j2d_dev_range, device)
    hips = uniform(generator, (B, num_joints, 2), *cfg.delta_j2d_hip_dev_range, device)
    return ProxyDraws(verts, remove, centre, occlude, joints, hips)


def random_verts2d_deviation(vertices: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) vertices with (B, V, 2) noise added to x and y."""
    return torch.cat([vertices[..., :2] + noise, vertices[..., 2:]], dim=-1)


def random_joints2d_deviation(joints2d: torch.Tensor, noise: torch.Tensor,
                              hip_noise: torch.Tensor) -> torch.Tensor:
    """(B, 17, 2) COCO joints plus `noise`, the hips plus `hip_noise`."""
    J = joints2d.shape[1]
    is_hip = device_constant(tuple(j in C.COCO_HIP_JOINTS for j in range(J)), torch.bool,
                             joints2d.device)
    return joints2d + torch.where(is_hip[None, :, None], hip_noise, noise)


def random_remove_bodyparts(seg: torch.Tensor, classes_to_remove,
                            probabilities_to_remove, draws: torch.Tensor) -> torch.Tensor:
    """Per sample and class, zero the class's pixels of (B, H, W) `seg`
    where that class's (B,) draw is below its probability."""
    assert len(classes_to_remove) == len(probabilities_to_remove) == len(draws)
    for u, cls, prob in zip(draws, classes_to_remove, probabilities_to_remove):
        hit = (u < prob)[:, None, None] & (seg == cls)
        seg = torch.where(hit, torch.zeros_like(seg), seg)
    return seg


def random_occlude(seg: torch.Tensor, centre: torch.Tensor, occlude_draw: torch.Tensor,
                   occlude_probability: float = 0.5,
                   occlude_box_dim: int = 48) -> torch.Tensor:
    """Zero a box of side `occlude_box_dim` around the (B, 2) (row, col)
    centre of each (B, H, W) map whose (B,) draw is below the probability;
    box corners truncate toward zero."""
    B, H, W = seg.shape
    occlude = occlude_draw < occlude_probability
    half = occlude_box_dim / 2.0
    r0 = (centre[:, 0] - half).to(torch.int32)
    r1 = (centre[:, 0] + half).to(torch.int32)
    c0 = (centre[:, 1] - half).to(torch.int32)
    c1 = (centre[:, 1] + half).to(torch.int32)
    rows = torch.arange(H, device=seg.device)[None, :, None]
    cols = torch.arange(W, device=seg.device)[None, None, :]
    in_box = ((rows >= r0[:, None, None]) & (rows < r1[:, None, None])
              & (cols >= c0[:, None, None]) & (cols < c1[:, None, None]))
    hit = in_box & occlude[:, None, None]
    return torch.where(hit, torch.zeros_like(seg), seg)


def augment_proxy_representation(segs: torch.Tensor, joints2d: torch.Tensor,
                                 draws: ProxyDraws, cfg: ProxyAugmentConfig
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Part removal, then occlusion, on the part maps; joint noise on the
    joints, each as `cfg` enables it."""
    if cfg.remove_appendages:
        segs = random_remove_bodyparts(segs, cfg.remove_appendages_classes,
                                       cfg.remove_appendages_probabilities, draws.remove)
    if cfg.occlude_seg:
        segs = random_occlude(segs, draws.occlude_centre, draws.occlude,
                              occlude_probability=cfg.occlude_probability,
                              occlude_box_dim=cfg.occlude_box_dim)
    if cfg.deviate_joints2D:
        joints2d = random_joints2d_deviation(joints2d, draws.joints_noise, draws.hip_noise)
    return segs, joints2d
