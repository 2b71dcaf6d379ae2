"""The SMPL body model: assets and the forward (counterpart of
`straps_tpu/smpl/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.smpl.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.smpl.assets import SmplAssets, load_assets, load_synthetic_assets
from straps_tpu_torch.smpl.model import SmplOutput, smpl_forward, smpl_forward_axis_angle

__all__ = ["SmplAssets", "load_assets", "load_synthetic_assets", "SmplOutput", "smpl_forward",
           "smpl_forward_axis_angle"]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
