"""Camera translation jitter (counterpart of `straps_tpu/augment/cam_aug.py`).

`augment_cam_t` takes its draws as arguments, the values of the JAX
package's two `jax.random` calls; `draw_cam_jitter` makes them from a
`torch.Generator`.
"""

from typing import Tuple

import torch

from straps_tpu_torch.augment.draws import uniform
from straps_tpu_torch.config import CamAugmentConfig


def draw_cam_jitter(generator: torch.Generator, batch_size: int,
                    cfg: CamAugmentConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2) standard normal xy draws and (B,) z draws uniform in
    `delta_z_range`."""
    xy = torch.randn((batch_size, 2), generator=generator, device=device)
    return xy, uniform(generator, (batch_size,), *cfg.delta_z_range, device)


def augment_cam_t(mean_cam_t: torch.Tensor, xy_normal: torch.Tensor,
                  delta_z: torch.Tensor, xy_std: float = 0.05) -> torch.Tensor:
    """Gaussian xy jitter and uniform z jitter around the mean camera
    translation: (B, 3) mean, (B, 2) normal draws, (B,) z draws -> (B, 3)."""
    delta_xy = xy_normal * xy_std
    return torch.cat([mean_cam_t[:, :2] + delta_xy,
                      (mean_cam_t[:, 2] + delta_z)[:, None]], dim=1)
