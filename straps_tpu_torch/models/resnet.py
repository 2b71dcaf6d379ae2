"""ResNet-18 encoder (counterpart of `straps_tpu/models/resnet.py`).

torchvision's architecture and state-dict names (`conv1`, `bn1`,
`layer1.0.conv1`, `layer2.0.downsample.0`, ...), an N-channel first conv,
no classification head: the output is the globally average-pooled feature.
BatchNorm eps 1e-5, updated in training mode as flax's BatchNorm updates
it.  Only BasicBlock depths are ported (ResNet-18 is the regressor of the
ported paths).
"""

import torch
from torch import nn

DEPTH_CONFIGS = {18: (2, 2, 2, 2)}   # BasicBlocks per stage
FEATURE_DIMS = {18: 512}


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, momentum 0.1, the same state-dict names)
    whose training mode is flax's BatchNorm (`momentum=0.9`, the JAX
    package's encoder).  The batch statistics are float32 whatever the
    input's dtype (bfloat16 under autocast), and the variance is flax's
    E[x²] - E[x]², clamped at 0: the biased variance, where torch's update
    takes the unbiased one, and with flax's rounding, which the gradients
    of channels of small variance follow.  The output is
    `((x - mean) * (rsqrt(var + eps) * weight) + bias)` in float32, cast
    back to the input's dtype.  Evaluation mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dim=dims)
        var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


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
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNetEncoder(nn.Module):
    """ResNet without the classification head: NCHW in, (B, 512) out."""

    def __init__(self, in_channels: int = 3, layers=DEPTH_CONFIGS[18]):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes = 64
        for stage, num_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(BasicBlock(in_planes, planes, stride))
                in_planes = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # Pooled in the compute dtype, returned as float32 (as the reference).
        return x.mean(dim=(2, 3)).float()
