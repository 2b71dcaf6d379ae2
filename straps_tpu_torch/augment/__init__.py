"""Synthetic-training augmentations (counterpart of `straps_tpu/augment/`).

Every function takes its random draws as tensor arguments, the values the
JAX package's `jax.random` calls give at the same places; each module's
`draw_*` function makes them from a `torch.Generator` on the tensors'
device.  So the JAX package's two shape samplers, which take a JAX key,
are `draw_delta_betas` (the draws) and `augment_smpl` (the shapes made of
them) here.  `JAX_COUNTERPARTS` maps each name of
`straps_tpu.augment.__all__` to its counterparts.
"""

from straps_tpu_torch.augment.cam_aug import augment_cam_t
from straps_tpu_torch.augment.proxy_aug import (
    augment_proxy_representation, random_joints2d_deviation, random_occlude,
    random_remove_bodyparts, random_verts2d_deviation,
)
from straps_tpu_torch.augment.smpl_aug import augment_smpl, draw_delta_betas

__all__ = [
    "draw_delta_betas", "augment_smpl", "augment_cam_t", "random_verts2d_deviation",
    "random_joints2d_deviation", "random_remove_bodyparts", "random_occlude",
    "augment_proxy_representation",
]

JAX_COUNTERPARTS = {
    "uniform_sample_shape": ("draw_delta_betas", "augment_smpl"),
    "normal_sample_shape": ("draw_delta_betas", "augment_smpl"),
    **{name: (name,) for name in __all__[1:]},
}
