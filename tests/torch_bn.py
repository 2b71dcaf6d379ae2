"""The BatchNorm input shapes of the port's encoders, read by forward hooks.

Imports neither JAX nor the JAX package: the card's tests and
`chip_smoke.py` use it.
"""

import torch

from straps_tpu_torch.models import resnet as R


def bn_input_shapes(depth: int, batch: int, img_wh: int = 256, in_channels: int = 18):
    """(N, C, H, W) of every BatchNorm input of the ResNet encoder at
    `depth`, in call order, for a batch of `batch` proxies of `img_wh`²:
    one CPU forward at an eighth of the size (each stage halves it), the
    sizes scaled back."""
    enc = R._depth(depth, in_channels).eval()
    shapes = []
    for m in enc.modules():
        if isinstance(m, R.BatchNorm2d):
            m.register_forward_hook(lambda mod, i, o: shapes.append(tuple(i[0].shape)))
    with torch.no_grad():
        enc(torch.zeros(1, in_channels, img_wh // 8, img_wh // 8))
    return [(batch, c, h * 8, w * 8) for _, c, h, w in shapes]


def channel_bounds(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """Per channel, how far two float32 summation orders of the training
    statistics may move y = (x - mean) * rsqrt(var + eps) * weight + bias:
    E[x²] - E[x]² by a few (8) float32 ulps of E[x²], so r = rsqrt(var + eps)
    by half that over var + eps, relatively (`rel`, large only for a channel
    whose variance is near 0: rounding noise against eps); and the mean by
    a few (4) ulps, which mul carries into y (`abs`).  Held by the
    plain formula and the kernels alike."""
    xf = x.double()
    mean = xf.mean(dim=(0, 2, 3))
    ex2 = xf.square().mean(dim=(0, 2, 3))
    var = (ex2 - mean.square()).clamp(min=0.0)
    rel = 0.5 * 8 * 2.0 ** -24 * ex2 / (var + eps)
    absolute = 4 * 2.0 ** -24 * mean.abs() * (var + eps).rsqrt() * weight.double().abs()
    return rel.float(), absolute.float()


def within_bound(got, want, dtype, rel_c, abs_c, factor=1.0):
    """max |got - want| over its bound, elementwise: one ulp of the larger
    in bfloat16 (2^-7 of it at most) or 1e-5 of it in float32, plus
    `factor` times the channel's `rel_c` of it and its `abs_c`, plus 1e-6 of
    the largest (float32 cancellation near 0).  At most 1 passes."""
    a, b = got.detach().float(), want.detach().float()
    shape = (1, -1, 1, 1)
    rel = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) + factor * rel_c.view(shape)
    bound = rel * torch.maximum(a.abs(), b.abs()) + abs_c.view(shape) + 1e-6 * b.abs().max()
    return float(((a - b).abs() / bound).max())


def float64_truth(x, weight, bias, dy, eps: float = 1e-5):
    """y and dx of the plain training formula in float64 under autograd:
    what either float32 implementation is held to."""
    xd = x.detach().double().requires_grad_(True)
    mean = xd.mean(dim=(0, 2, 3))
    var = torch.clamp(xd.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    mul = torch.rsqrt(var + eps) * weight.detach().double()
    y = (xd - mean[:, None, None]) * mul[:, None, None] + bias.detach().double()[:, None, None]
    y.backward(dy.double())
    return y.detach(), xd.grad
