"""ResNet-FPN backbone of the detectors (counterpart of
`straps_tpu/perception/fpn.py`), with detectron2's module names, so that a
detectron2 checkpoint loads by name: `bottom_up.stem.conv1[.norm]`,
`bottom_up.res2.0.conv1[.norm]`, `bottom_up.res2.0.shortcut[.norm]`,
`fpn_lateral2`, `fpn_output2`, ...

MSRA ResNet-50/101 (stride in the 1x1 conv, FrozenBatchNorm), res2..res5
-> 1x1 laterals -> top-down nearest 2x upsampling -> 3x3 output convs ->
P2..P5, plus P6 = a stride-2 pool of P5 for the RPN.  NCHW.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

FPN_STRIDES = (4, 8, 16, 32, 64)
DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBatchNorm2d(nn.Module):
    """detectron2's FrozenBatchNorm2d: a per-channel affine from fixed
    statistics, scale = weight * rsqrt(var + eps), shift = bias - mean *
    scale (eps 1e-5).  All four tensors are buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.view(1, -1, 1, 1).to(x.dtype) + shift.view(1, -1, 1, 1).to(x.dtype)


class Conv2dNorm(nn.Conv2d):
    """detectron2's `layers.Conv2d`: a convolution followed by its `norm`."""

    def __init__(self, *args, norm: nn.Module = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return x if self.norm is None else self.norm(x)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, bottleneck: int, out_channels: int, stride: int):
        super().__init__()
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = Conv2dNorm(in_channels, out_channels, 1, stride, bias=False,
                                       norm=FrozenBatchNorm2d(out_channels))
        self.conv1 = Conv2dNorm(in_channels, bottleneck, 1, stride, bias=False,
                                norm=FrozenBatchNorm2d(bottleneck))
        self.conv2 = Conv2dNorm(bottleneck, bottleneck, 3, 1, 1, bias=False,
                                norm=FrozenBatchNorm2d(bottleneck))
        self.conv3 = Conv2dNorm(bottleneck, out_channels, 1, bias=False,
                                norm=FrozenBatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class BasicStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2dNorm(3, 64, 7, 2, 3, bias=False, norm=FrozenBatchNorm2d(64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


class ResNet(nn.Module):
    """Bottom-up stages res2..res5 of an MSRA ResNet-50/101."""

    def __init__(self, depth: int = 50):
        super().__init__()
        self.stem = BasicStem()
        cin, bottleneck = 64, 64
        for s, n in enumerate(DEPTH_BLOCKS[depth]):
            blocks = []
            for b in range(n):
                stride = 2 if s > 0 and b == 0 else 1
                blocks.append(BottleneckBlock(cin, bottleneck, bottleneck * 4, stride))
                cin = bottleneck * 4
            self.add_module(f"res{s + 2}", nn.Sequential(*blocks))
            bottleneck *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        stages = []
        for s in range(2, 6):
            x = getattr(self, f"res{s}")(x)
            stages.append(x)
        return stages


class FPNBackbone(nn.Module):
    """image (B, 3, H, W) -> [P2, P3, P4, P5, P6], float32 whatever the
    compute dtype (the heads, ROIAlign and NMS run in float32)."""

    def __init__(self, depth: int = 50, out_channels: int = 256):
        super().__init__()
        self.bottom_up = ResNet(depth)
        for i, cin in enumerate((256, 512, 1024, 2048)):
            self.add_module(f"fpn_lateral{i + 2}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{i + 2}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stages = self.bottom_up(x)
        lat = [getattr(self, f"fpn_lateral{i + 2}")(s) for i, s in enumerate(stages)]
        merged = [None, None, None, lat[3]]
        for i in (2, 1, 0):
            # Half-pixel-centred nearest resampling (`jax.image.resize`'s
            # "nearest"); equal to a 2x repeat where the sizes are exact.
            merged[i] = lat[i] + F.interpolate(merged[i + 1], size=lat[i].shape[-2:],
                                               mode="nearest-exact")
        outs = [getattr(self, f"fpn_output{i + 2}")(m) for i, m in enumerate(merged)]
        outs.append(F.max_pool2d(outs[3], kernel_size=1, stride=2))
        return [o.float() for o in outs]
