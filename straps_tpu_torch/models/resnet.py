"""ResNet encoders (counterpart of `straps_tpu/models/resnet.py`).

torchvision's architecture and state-dict names (`conv1`, `bn1`,
`layer1.0.conv1`, `layer2.0.downsample.0`, ...), an N-channel first conv,
no classification head: the output is the globally average-pooled feature.
BatchNorm eps 1e-5, updated in training mode as flax's BatchNorm updates
it.  Every depth of the JAX package: BasicBlock (18, 34) and Bottleneck
(50, 101, 152; ResNeXt and wide through `groups` and `base_width`).  The
Bottleneck strides in its 3x3 `conv2`, as torchvision's and the JAX
regressor encoder's (`stride_in_1x1=False`); detectron2's trunks of
`perception/fpn.py` stride in the 1x1.
"""

import contextlib
import ctypes
import functools
import os
import threading
from typing import Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from straps_tpu_torch.parallel.mesh import all_reduce_, all_reduce_sum
from straps_tpu_torch.utils import native_build

# Threads of a kernel block, and the blocks a launch aims for: several on
# each of the H100's 132 multiprocessors.
KERNEL_THREADS = 256
_TARGET_BLOCKS = 4 * 132
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TILES = 2048


@functools.lru_cache(maxsize=None)
def batchnorm_geometry(m: int, c: int, vec: int) -> Tuple[int, int, int]:
    """(lanes, tiles, slices) of the BatchNorm kernels' grid over an (m, c)
    channels-last activation read `vec` channels at a time: a block is
    `lanes` vectors of channels (a power of two up to 32) by
    KERNEL_THREADS / lanes rows, `tiles` blocks cover the channels and
    `slices` blocks the rows, as many as give _TARGET_BLOCKS blocks while
    each thread keeps four rows or more.  Depends on the shape alone, so
    the sums' order, and every output, repeat from run to run."""
    vecs = -(-c // vec)
    lanes = 1
    while lanes < min(vecs, 32):
        lanes *= 2
    tiles = -(-vecs // lanes)
    rows = KERNEL_THREADS // lanes
    slices = max(1, min(-(-_TARGET_BLOCKS // tiles), m // (4 * rows), 65535))
    return lanes, tiles, slices


class _BatchNormKernels:
    """The four kernels of `csrc/batchnorm.cu` (statistics, normalisation,
    backward sums, backward dx): the library, built with nvcc at first use;
    the tile counters of each (device, stream), zero between launches, so
    that launches on two streams at once use their own; and `launches`,
    every kernel launched.  Each call checks its tensors and raises
    ValueError on what the kernels do not take: another device than CUDA,
    a dtype other than float32 or bfloat16, a layout other than
    channels-last (N, C, H, W)."""

    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    SIGNATURES = {
        "batchnorm_stats_launch": [_P] * 4 + [_I] * 6 + [_P],
        "batchnorm_normalize_launch": [_P] * 9 + [_I] * 6 + [_F] * 4 + [_P],
        "batchnorm_backward_sums_launch": [_P] * 8 + [_I] * 6 + [_P],
        "batchnorm_backward_dx_launch": [_P] * 5 + [_I] * 6 + [_F, _P],
    }

    def __init__(self):
        self.source = os.path.join(native_build.CSRC_DIR, "batchnorm.cu")
        self.launches = 0
        self._lib = None
        self._counters = {}
        self._lock = threading.Lock()

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(native_build.cuda_library(self.source))
                for name, argtypes in self.SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                self._lib = lib
            return self._lib

    def _layout(self, x: torch.Tensor, *like: torch.Tensor):
        """(dtype code, m, c, vec, lanes, tiles, slices) of channels-last
        `x`; the tensors `like` must match it."""
        for t in (x,) + like:
            if t.device.type != "cuda" or t.dtype not in _DTYPE_CODES or t.dim() != 4 \
                    or not t.is_contiguous(memory_format=torch.channels_last) \
                    or t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
                raise ValueError(
                    f"BatchNorm kernels take channels-last float32 or bfloat16 (N, C, H, W) "
                    f"CUDA tensors of one shape; got {t.dtype} {tuple(t.shape)} strides "
                    f"{t.stride()} on {t.device}")
        n, c, h, w = x.shape
        m = n * h * w
        if not (0 < m < 2 ** 31 and 0 < c < 65536):
            raise ValueError(f"BatchNorm kernels: bad shape {tuple(x.shape)}")
        vec = 16 // x.element_size()
        if c % vec or any(t.data_ptr() % 16 for t in (x,) + like):
            vec = 1
        return (_DTYPE_CODES[x.dtype], m, c, vec) + batchnorm_geometry(m, c, vec)

    @staticmethod
    def _float32(shape: tuple, dev: torch.device, **tensors: torch.Tensor):
        for name, v in tensors.items():
            if v is None or v.dtype != torch.float32 or v.shape != shape \
                    or not v.is_contiguous() or v.device != dev:
                raise ValueError(f"BatchNorm kernels: {name} must be a contiguous float32 "
                                 f"{shape} tensor on {dev}")

    def _tile_counters(self, dev: torch.device) -> torch.Tensor:
        """The stream's counters, made at its first launch and never
        replaced, for a CUDA graph captured on the stream keeps their
        address: as many as any channel count gives tiles (`_layout` takes
        c < 65536, so at most 2048 tiles of 32 lanes)."""
        key = (dev, torch.cuda.current_stream(dev).cuda_stream)
        counters = self._counters.get(key)
        if counters is None:
            counters = self._counters[key] = torch.zeros(_MAX_TILES, dtype=torch.int32,
                                                         device=dev)
        return counters

    def _launch(self, name: str, dev: torch.device, *args):
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        fn = getattr(self.library(), name)
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        self.launches += 1

    def stats(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel 1: (2, C) float32 [sum x, sum x^2] over N, H, W."""
        code, m, c, vec, lanes, tiles, slices = self._layout(x)
        partials = torch.empty((slices, 2, c), dtype=torch.float64, device=x.device)
        sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
        self._launch("batchnorm_stats_launch", x.device, x, partials, sums,
                     self._tile_counters(x.device), code, m, c, vec, lanes, slices)
        return sums

    def normalize(self, x, sums, weight, bias, running_mean, running_var,
                  num_batches_tracked, count: int, eps: float, momentum: float):
        """Kernel 2: y = (x - mean) * mul + bias in x's dtype and the (4, C)
        [mean, mul, rsqrt(var + eps), k] from the global `sums` over `count`
        elements a channel; updates the running statistics and
        `num_batches_tracked` in place."""
        code, m, c, vec, lanes, tiles, slices = self._layout(x)
        self._float32((c,), x.device, weight=weight, bias=bias, running_mean=running_mean,
                      running_var=running_var)
        self._float32((2, c), x.device, sums=sums)
        if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.device != x.device:
            raise ValueError("BatchNorm kernels: num_batches_tracked must be int64 on "
                             f"{x.device}")
        y = torch.empty_like(x)
        stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
        self._launch("batchnorm_normalize_launch", x.device, x, y, sums, weight, bias,
                     running_mean, running_var, num_batches_tracked, stats, code, m, c, vec,
                     lanes, slices, float(count), eps, momentum, 1.0 - momentum)
        return y, stats

    def backward_sums(self, dy, x, stats):
        """Kernel 3: (2, C) [sum dy, sum dy * (x - mean)] and the weight's and
        bias's gradients of this process's rows."""
        code, m, c, vec, lanes, tiles, slices = self._layout(x, dy)
        self._float32((4, c), x.device, stats=stats)
        partials = torch.empty((slices, 2, c), dtype=torch.float64, device=x.device)
        sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
        dweight = torch.empty((c,), dtype=torch.float32, device=x.device)
        dbias = torch.empty((c,), dtype=torch.float32, device=x.device)
        self._launch("batchnorm_backward_sums_launch", x.device, dy, x, stats, partials, sums,
                     self._tile_counters(x.device), dweight, dbias, code, m, c, vec,
                     lanes, slices)
        return sums, dweight, dbias

    def backward_dx(self, dy, x, stats, sums, count: int) -> torch.Tensor:
        """Kernel 4: dx in x's dtype from the global `sums` over `count`."""
        code, m, c, vec, lanes, tiles, slices = self._layout(x, dy)
        self._float32((4, c), x.device, stats=stats)
        self._float32((2, c), x.device, sums=sums)
        dx = torch.empty_like(x)
        self._launch("batchnorm_backward_dx_launch", x.device, dy, x, stats, sums, dx, code, m,
                     c, vec, lanes, slices, float(count))
        return dx


batchnorm_kernels = _BatchNormKernels()


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the arithmetic's dtype: float32, float64 for a float64 x."""
    return x.double() if x.dtype == torch.float64 else x.float()


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


# The kernels' arithmetic in plain PyTorch, stage by stage: the definition
# the kernels are held to on the card (tests/test_torch_batchnorm_cuda.py),
# and held to autograd of the plain training formula on the CPU.  Float32
# arithmetic on float32 or bfloat16 inputs, float64 on float64 ones.  A
# division by the element count divides by a tensor (a true division, as
# the kernels'; PyTorch multiplies by the reciprocal of a Python number).

def batchnorm_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """Kernel 1: (2, C) [sum x, sum x^2] over N, H, W."""
    xf = _acc(x)
    return torch.stack([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3))])


def batchnorm_coefficients_reference(sums: torch.Tensor, count: int, weight: torch.Tensor,
                                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's per-channel part: (4, C) [mean, mul, r, k] and the clamped
    variance, from the global sums over `count` elements a channel.
    r = rsqrt(var + eps), mul = r * weight, k = r * r, or 0 where
    E[x^2] - E[x]^2 < 0 (the clamp passes no gradient there)."""
    n = torch.full_like(sums[0], count)
    mean = sums[0] / n
    raw = sums[1] / n - mean * mean
    var = torch.clamp(raw, min=0.0)
    r = torch.rsqrt(var + eps)
    k = torch.where(raw >= 0, r * r, torch.zeros_like(r))
    return torch.stack([mean, r * weight, r, k]), var


def batchnorm_normalize_reference(x: torch.Tensor, stats: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """Kernel 2's output: ((x - mean) * mul + bias) in x's dtype."""
    y = (_acc(x) - _per_channel(stats[0])) * _per_channel(stats[1]) + _per_channel(bias)
    return y.to(x.dtype)


def batchnorm_backward_sums_reference(dy: torch.Tensor, x: torch.Tensor,
                                      stats: torch.Tensor) -> torch.Tensor:
    """Kernel 3: (2, C) [sum dy, sum dy * (x - mean)]; the bias's gradient
    is the first, the weight's the second times r."""
    g = _acc(dy)
    return torch.stack([g.sum(dim=(0, 2, 3)),
                        (g * (_acc(x) - _per_channel(stats[0]))).sum(dim=(0, 2, 3))])


def batchnorm_backward_dx_reference(dy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                                    sums: torch.Tensor, count: int) -> torch.Tensor:
    """Kernel 4: dx = mul * ((dy - sum dy / N) - (x - mean) * (k * sum dy (x - mean) / N)),
    in x's dtype, from the global backward sums over `count` elements."""
    n = torch.full_like(sums[0], count)
    c1, c2 = sums[0] / n, sums[1] * stats[3] / n
    dx = _per_channel(stats[1]) * ((_acc(dy) - _per_channel(c1))
                                   - (_acc(x) - _per_channel(stats[0])) * _per_channel(c2))
    return dx.to(x.dtype)


class _TrainBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm through the kernels: statistics (all-reduced
    over the data mesh), normalisation; in the backward pass the channel
    sums (all-reduced) and dx.  Saves x and the (4, C) statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, norm):
        mesh = norm.mesh
        count = x.numel() // x.shape[1] * (1 if mesh is None else mesh.size)
        sums = batchnorm_kernels.stats(x)
        if mesh is not None:
            all_reduce_([sums], mesh)
        y, stats = batchnorm_kernels.normalize(x, sums, weight, bias, norm.running_mean,
                                               norm.running_var, norm.num_batches_tracked,
                                               count, norm.eps, norm.momentum)
        ctx.save_for_backward(x, stats)
        ctx.mesh, ctx.count = mesh, count
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stats = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        sums, dweight, dbias = batchnorm_kernels.backward_sums(dy, x, stats)
        if ctx.mesh is not None:
            all_reduce_([sums], ctx.mesh)
        return batchnorm_kernels.backward_dx(dy, x, stats, sums, ctx.count), dweight, dbias, None


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, momentum 0.1, the same state-dict names)
    whose training mode is flax's BatchNorm (`momentum=0.9`, the JAX
    package's encoder).  The batch statistics are float32 whatever the
    input's dtype (bfloat16 under autocast), and the variance is flax's
    E[x²] - E[x]², clamped at 0: the biased variance, where torch's update
    takes the unbiased one, and with flax's rounding, which the gradients
    of channels of small variance follow.  The output is
    `((x - mean) * (rsqrt(var + eps) * weight) + bias)` in float32, cast
    back to the input's dtype.  Evaluation mode is torch's; with
    `bfloat16_variance` set (weights whose flax running variance was
    bfloat16, `models/convert.py::bfloat16_variance_layers`) it is flax's
    arithmetic under jit on the CPU on such a variance: `var + eps` in
    bfloat16 (eps rounded to it, the sum rounded), its `rsqrt` rounded to
    bfloat16 too where the scale was bfloat16 ("root") and not where it was
    float32 ("sum"), the rest in float32.

    With a data mesh (`mesh`, set within `use_data_mesh`) the training-mode
    statistics are the global batch's, as flax's over a sharded batch: one
    differentiable all-reduce a layer of the stacked float32 [Σx, Σx²]
    (2C values) over the global element count, so the running statistics
    update alike on every rank.

    Training mode on a CUDA tensor goes through the kernels of
    `csrc/batchnorm.cu` (`_TrainBatchNorm`): the same arithmetic in four
    passes, bfloat16 or float32 in and out, float32 statistics, in the
    channels-last layout the encoder runs in (another layout is copied to
    it first, and y keeps it); over a mesh the (2, C) sums are all-reduced
    in the forward and the backward pass, one collective each, as above.
    The `batchnorm_*_reference` functions are the kernels' arithmetic in
    plain PyTorch.  A CPU tensor keeps the formula below."""

    mesh = None
    bfloat16_variance = None          # None, "sum" or "root"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if not self.bfloat16_variance:
                return super().forward(x)
            eps = torch.tensor(self.eps, dtype=torch.bfloat16)
            total = self.running_var.to(torch.bfloat16) + eps
            if self.bfloat16_variance == "root":
                root = torch.rsqrt(total).float()
            else:
                root = torch.rsqrt(total.float())
            mul = root * self.weight
            y = ((x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
            return y.to(x.dtype)
        if x.is_cuda:
            return _TrainBatchNorm.apply(x.contiguous(memory_format=torch.channels_last),
                                         self.weight, self.bias, self)
        return self.plain_train_forward(x)

    def plain_train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The training-mode formula in plain PyTorch on any device: what a
        CPU tensor takes, and the card's tests' yardstick for the kernels."""
        xf = x.float()
        dims = (0, 2, 3)
        if self.mesh is None:
            mean = xf.mean(dim=dims)
            var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
        else:
            count = xf.numel() // xf.shape[1] * self.mesh.size
            sums = all_reduce_sum(torch.stack([xf.sum(dim=dims), xf.square().sum(dim=dims)]),
                                  self.mesh) / count
            mean = sums[0]
            var = torch.clamp(sums[1] - mean.square(), min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def use_data_mesh(module: nn.Module, mesh):
    """Within the block, every `BatchNorm2d` of `module` takes its
    training-mode statistics over the global batch of the data mesh `mesh`
    (None: this process's batch); after it, over this process's batch."""
    norms = [] if mesh is None else [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


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
