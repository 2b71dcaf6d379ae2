"""Encoder + IEF: proxy representation -> SMPL parameters + camera
(counterpart of `straps_tpu/models/regressor.py`), with the reference's
state-dict names `image_encoder.*` and `ief_module.fc1..3`."""

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from straps_tpu_torch.models.ief import IEFModule, make_initial_params_estimate
from straps_tpu_torch.models.resnet import (
    DEPTH_CONFIGS, FEATURE_DIMS, BasicBlock, ResNetEncoder,
)


class SingleInputRegressor(nn.Module):
    """NHWC proxy (B, H, W, C) -> cam (B, 3), pose6d (B, 144), shape (B, 10).

    `compute_dtype='bfloat16'` runs the encoder under autocast; parameters,
    the IEF head and the outputs stay float32.  Autocast keeps no cache of
    the weights' casts (each weight is cast once a forward pass either
    way), so that a CUDA graph can capture the forward pass.
    """

    def __init__(self, initial_estimate, in_channels: int = 18,
                 resnet_layers: int = 18, ief_iters: int = 3,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if resnet_layers not in DEPTH_CONFIGS:
            raise ValueError(f"unsupported resnet_layers={resnet_layers} "
                             f"(have {sorted(DEPTH_CONFIGS)})")
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        block, layers = DEPTH_CONFIGS[resnet_layers]
        self.image_encoder = ResNetEncoder(in_channels, block, layers)
        # The reference's fc widths, [512, 512] for R18 and [1024, 1024] for
        # R50, by block family (as the JAX package).
        fc_neurons = (512, 512) if block is BasicBlock else (1024, 1024)
        self.ief_module = IEFModule(FEATURE_DIMS[resnet_layers], fc_neurons,
                                    initial_estimate, iterations=ief_iters)

    def forward(self, proxy: torch.Tensor):
        # NHWC at the boundary; the permuted view is channels-last in memory.
        x = proxy.permute(0, 3, 1, 2)
        if self.compute_dtype == "bfloat16":
            ctx = torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                                 cache_enabled=False)
        else:
            # A bfloat16 proxy (the predict input cast) promotes to float32.
            ctx = contextlib.nullcontext()
            x = x.float()
        with ctx:
            feats = self.image_encoder(x)
        return self.ief_module(feats.float())


def build_regressor(mean_pose_6d, mean_shape, in_channels: int = 18,
                    resnet_layers: int = 18, ief_iters: int = 3,
                    compute_dtype: Optional[str] = None) -> SingleInputRegressor:
    init = make_initial_params_estimate(mean_pose_6d, mean_shape)
    return SingleInputRegressor(init, in_channels=in_channels,
                                resnet_layers=resnet_layers,
                                ief_iters=ief_iters,
                                compute_dtype=compute_dtype)


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights drawn on the CPU, so that one seed gives the
    same weights on every device: conv and linear weights N(0, 1/fan_in)
    (lecun normal), biases and BatchNorm shift 0, BatchNorm scale 1, running
    statistics (0, 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
