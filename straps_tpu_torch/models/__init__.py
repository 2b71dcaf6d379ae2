"""Regressor network: ResNet encoders (every depth of the JAX package), the
IEF head, weight conversion (counterpart of `straps_tpu/models/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.models.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.models.convert import (
    flax_to_torch_state_dict, load_reference_checkpoint, torch_state_dict_to_flax,
)
from straps_tpu_torch.models.ief import (
    NUM_CAM_PARAMS, NUM_OUTPUT_PARAMS, NUM_POSE_PARAMS, NUM_SHAPE_PARAMS, IEFModule,
    make_initial_params_estimate,
)
from straps_tpu_torch.models.regressor import SingleInputRegressor, build_regressor
from straps_tpu_torch.models.resnet import (
    FEATURE_DIMS, ResNetEncoder, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext101_32x8d, wide_resnet50_2, wide_resnet101_2,
)

__all__ = [
    "ResNetEncoder", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
    "FEATURE_DIMS", "IEFModule", "make_initial_params_estimate", "NUM_CAM_PARAMS",
    "NUM_POSE_PARAMS", "NUM_SHAPE_PARAMS", "NUM_OUTPUT_PARAMS", "SingleInputRegressor",
    "build_regressor", "torch_state_dict_to_flax", "flax_to_torch_state_dict",
    "load_reference_checkpoint",
]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
