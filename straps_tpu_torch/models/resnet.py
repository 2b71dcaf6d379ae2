"""ResNet encoders (counterpart of `straps_tpu/models/resnet.py`).

torchvision's architecture and state-dict names (`conv1`, `bn1`,
`layer1.0.conv1`, `layer2.0.downsample.0`, ...), an N-channel first conv,
no classification head: the output is the globally average-pooled feature.
BatchNorm eps 1e-5, updated in training mode as flax's BatchNorm updates
it (`models/batchnorm.py`).  Every depth of the JAX package: BasicBlock (18, 34) and Bottleneck
(50, 101, 152; ResNeXt and wide through `groups` and `base_width`).  The
Bottleneck strides in its 3x3 `conv2`, as torchvision's and the JAX
regressor encoder's (`stride_in_1x1=False`); detectron2's trunks of
`perception/fpn.py` stride in the 1x1.
"""

import torch
from torch import nn

from straps_tpu_torch.models.batchnorm import BatchNorm2d


def _downsample(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
                         BatchNorm2d(out_planes, eps=1e-5))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = _downsample(in_planes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, `groups`) -> 1x1 (x4), torchvision's names;
    `width = int(planes * base_width / 64) * groups`."""
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_planes != out_planes:
            self.downsample = _downsample(in_planes, out_planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


# Depth -> (block, blocks per stage): torchvision's table, as the JAX
# package's `DEPTH_CONFIGS`.
DEPTH_CONFIGS = {18: (BasicBlock, (2, 2, 2, 2)),
                 34: (BasicBlock, (3, 4, 6, 3)),
                 50: (Bottleneck, (3, 4, 6, 3)),
                 101: (Bottleneck, (3, 4, 23, 3)),
                 152: (Bottleneck, (3, 8, 36, 3))}
# Pooled feature dims per depth (BasicBlock 512, Bottleneck 2048).
FEATURE_DIMS = {18: 512, 34: 512, 50: 2048, 101: 2048, 152: 2048}


class ResNetEncoder(nn.Module):
    """ResNet without the classification head: NCHW in, (B, 512 x the
    block's expansion) float32 out."""

    def __init__(self, in_channels: int = 3, block=BasicBlock, layers=(2, 2, 2, 2),
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        kwargs = {"groups": groups, "base_width": base_width} if block is Bottleneck else {}
        in_planes = 64
        for stage, num_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(in_planes, planes, stride, **kwargs))
                in_planes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # Pooled in the compute dtype, returned as float32 (as the reference).
        return x.mean(dim=(2, 3)).float()


def _depth(depth: int, in_channels: int) -> ResNetEncoder:
    block, layers = DEPTH_CONFIGS[depth]
    return ResNetEncoder(in_channels, block, layers)


def resnet18(in_channels: int = 3) -> ResNetEncoder:
    return _depth(18, in_channels)


def resnet34(in_channels: int = 3) -> ResNetEncoder:
    return _depth(34, in_channels)


def resnet50(in_channels: int = 3) -> ResNetEncoder:
    return _depth(50, in_channels)


def resnet101(in_channels: int = 3) -> ResNetEncoder:
    return _depth(101, in_channels)


def resnet152(in_channels: int = 3) -> ResNetEncoder:
    return _depth(152, in_channels)


def resnext50_32x4d(in_channels: int = 3) -> ResNetEncoder:
    return ResNetEncoder(in_channels, Bottleneck, (3, 4, 6, 3), groups=32, base_width=4)


def resnext101_32x8d(in_channels: int = 3) -> ResNetEncoder:
    return ResNetEncoder(in_channels, Bottleneck, (3, 4, 23, 3), groups=32, base_width=8)


def wide_resnet50_2(in_channels: int = 3) -> ResNetEncoder:
    return ResNetEncoder(in_channels, Bottleneck, (3, 4, 6, 3), base_width=128)


def wide_resnet101_2(in_channels: int = 3) -> ResNetEncoder:
    return ResNetEncoder(in_channels, Bottleneck, (3, 4, 23, 3), base_width=128)
