"""SMPL shape resampling and pose conversion (counterpart of
`straps_tpu/augment/smpl_aug.py`).

The functions take their random draws as arguments, each the value of the
JAX package's `jax.random` call at that place (same shape and range);
`draw_delta_betas` makes them from a `torch.Generator`.
"""

from typing import Optional, Tuple

import torch

from straps_tpu_torch.augment.draws import uniform
from straps_tpu_torch.config import SmplAugmentConfig
from straps_tpu_torch.geometry.rotations import rodrigues


def draw_delta_betas(generator: torch.Generator, batch_size: int, num_betas: int,
                     cfg: SmplAugmentConfig, device) -> torch.Tensor:
    """(B, num_betas) draws: standard normal for the 'normal' distribution,
    uniform in `delta_betas_range` for 'uniform'."""
    shape = (batch_size, num_betas)
    if cfg.delta_betas_distribution == "normal":
        return torch.randn(shape, generator=generator, device=device)
    if cfg.delta_betas_distribution == "uniform":
        return uniform(generator, shape, *cfg.delta_betas_range, device)
    raise ValueError(f"unknown distribution {cfg.delta_betas_distribution!r}")


def augment_smpl(delta_betas: Optional[torch.Tensor], orig_shape: torch.Tensor,
                 pose: torch.Tensor, global_orient: torch.Tensor,
                 mean_shape: torch.Tensor, cfg: SmplAugmentConfig,
                 augment_shape: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shape resampling (when `augment_shape`) + axis-angle -> rotation
    matrices.

    Args:
      delta_betas: (B, 10) draws of `draw_delta_betas` (unused, and may be
        None, without `augment_shape`).
      orig_shape: (B, 10) dataset betas; pose: (B, 69) body pose axis-angle;
      global_orient: (B, 3) root axis-angle; mean_shape: (10,).
    Returns:
      (new_shape (B, 10), pose_rotmats (B, 23, 3, 3), glob_rotmats (B, 1, 3, 3))
    """
    B = orig_shape.shape[0]
    if augment_shape:
        if cfg.delta_betas_distribution == "uniform":      # draws already in range
            new_shape = delta_betas + mean_shape
        elif cfg.delta_betas_distribution == "normal":
            std = torch.full_like(mean_shape, cfg.delta_betas_std)
            new_shape = delta_betas * std + mean_shape
        else:
            raise ValueError(f"unknown distribution {cfg.delta_betas_distribution!r}")
    else:
        new_shape = orig_shape
    pose_rotmats = rodrigues(pose.reshape(B, 23, 3))
    glob_rotmats = rodrigues(global_orient.reshape(B, 1, 3))
    return new_shape, pose_rotmats, glob_rotmats
