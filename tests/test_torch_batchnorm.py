"""The training-mode BatchNorm kernels' arithmetic (`models/batchnorm.py`'s
`batchnorm_*_reference`, the plain PyTorch version of `csrc/batchnorm.cu`)
against autograd of the plain training formula that `BatchNorm2d` keeps
for CPU tensors, in float64 on the CPU: the output, the running
statistics, and the gradients of the input, the weight and the bias,
with the variance's clamp at 0 both idle and active.  Then the kernels'
grid over every BatchNorm shape of ResNet-18 and ResNet-50 at 18 x 256²,
B=140, and the wrapper's refusals, which come before any build.

The card holds the kernels themselves to these functions
(`tests/test_torch_batchnorm_cuda.py`)."""

import pytest
import torch

from straps_tpu_torch.models import batchnorm as BN
from torch_bn import bn_input_shapes
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS, MOMENTUM = 1e-5, 0.1
# Float64 sums in another order than autograd's: a few ulps of the
# largest term.
TOL = 1e-11


def _plain(x, weight, bias):
    """`BatchNorm2d`'s training formula (flax's), in x's dtype."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    mul = torch.rsqrt(var + EPS) * weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None], mean, var


def _reference(x, weight, bias, dy):
    """The kernels' four stages in order: y, mean, var, dx, dweight, dbias, k."""
    count = x.numel() // x.shape[1]
    sums = BN.batchnorm_stats_reference(x)
    stats, var = BN.batchnorm_coefficients_reference(sums, count, weight, EPS)
    y = BN.batchnorm_normalize_reference(x, stats, bias)
    back = BN.batchnorm_backward_sums_reference(dy, x, stats)
    dx = BN.batchnorm_backward_dx_reference(dy, x, stats, back, count)
    return y, stats[0], var, dx, back[1] * stats[2], back[0], stats[3]


def _inputs(shape, seed, constant_channel=True):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2.0 + 0.5
    if constant_channel and c > 1:
        x[:, c // 2] = 0.7
    weight = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=g, dtype=torch.float64)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return x, weight, bias, dy


def _close(a, b, what):
    scale = b.abs().max().clamp(min=1.0)
    assert (a - b).abs().max() <= TOL * scale, (what, float((a - b).abs().max()))


def _grads(x, weight, bias, dy):
    x, weight, bias = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    y, mean, var = _plain(x, weight, bias)
    return (y.detach(), mean.detach(), var.detach(),
            *torch.autograd.grad(y, (x, weight, bias), dy))


# ResNet layer shapes at a small batch and size, and ragged ones: odd N,
# 7 x 7, three channels, one pixel.
SHAPES = [(2, 64, 16, 16), (2, 256, 8, 8), (2, 2048, 2, 2), (3, 3, 7, 7), (3, 128, 7, 7),
          (5, 16, 1, 1), (1, 64, 5, 3), (4, 512, 4, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_autograd_of_the_plain_formula(shape):
    x, weight, bias, dy = _inputs(shape, seed=sum(shape))
    y, mean, var, dx, dweight, dbias, _ = _reference(x, weight, bias, dy)
    y_p, mean_p, var_p, dx_p, dweight_p, dbias_p = _grads(x, weight, bias, dy)
    for got, want, what in ((y, y_p, "y"), (mean, mean_p, "mean"), (var, var_p, "var"),
                            (dx, dx_p, "dx"), (dweight, dweight_p, "dweight"),
                            (dbias, dbias_p, "dbias")):
        _close(got, want, what)


def test_reference_drops_the_variance_term_where_the_clamp_is_active():
    """Channel 1 sits at 1000 with a spread of 1e-6: its E[x²] - E[x]²
    rounds below 0 in both orders (seed 1), so the clamp passes no
    gradient to the variance; channel 3 is ordinary.  Keeping the term
    would move dx of channel 1 beyond a hundred times the tolerance."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 7, 7, generator=g, dtype=torch.float64)
    x[:, 1] = 1000 + 1e-6 * torch.randn(3, 7, 7, generator=g, dtype=torch.float64)
    x[:, 2] = 0.7
    weight = torch.tensor([1.0, 2.0, 0.5, 1.5], dtype=torch.float64)
    bias = torch.tensor([0.1, -0.2, 0.3, 0.0], dtype=torch.float64)
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    raw = x.square().mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)).square()
    assert raw[1] < 0 and raw[3] > 0
    y, mean, var, dx, dweight, dbias, k = _reference(x, weight, bias, dy)
    assert k[1] == 0 and k[3] > 0 and var[1] == 0
    y_p, _, var_p, dx_p, dweight_p, dbias_p = _grads(x, weight, bias, dy)
    for got, want, what in ((y, y_p, "y"), (var, var_p, "var"), (dx, dx_p, "dx"),
                            (dweight, dweight_p, "dweight"), (dbias, dbias_p, "dbias")):
        _close(got, want, what)
    # The variance term of channel 1, were it kept.
    r2 = torch.rsqrt(var[1] + EPS) ** 2
    d = x[:, 1] - mean[1]
    term = (weight[1] * torch.rsqrt(var[1] + EPS)) * d * r2 * (dy[:, 1] * d).sum() / d.numel()
    assert term.abs().max() > 100 * TOL * dx_p.abs().max()


def test_running_statistics_follow_the_module():
    """The kernels' running update `r * (1 - m) + s * m` from the
    reference's mean and variance equals the module's CPU update (float32
    buffers, float32 inputs)."""
    x, weight, bias, _ = _inputs((4, 32, 6, 6), seed=3)
    norm = BN.BatchNorm2d(32).train()
    with torch.no_grad():
        norm.weight.copy_(weight.float())
        norm.bias.copy_(bias.float())
        norm.running_mean.uniform_(-1, 1)
        norm.running_var.uniform_(0.5, 2)
    rm, rv = norm.running_mean.clone(), norm.running_var.clone()
    xf = x.float()
    norm(xf)
    sums = BN.batchnorm_stats_reference(xf)
    stats, var = BN.batchnorm_coefficients_reference(sums, xf.numel() // 32, norm.weight, EPS)
    want_m = rm * (1.0 - MOMENTUM) + stats[0] * MOMENTUM
    want_v = rv * (1.0 - MOMENTUM) + var * MOMENTUM
    assert torch.allclose(norm.running_mean, want_m, rtol=1e-6, atol=1e-7)
    assert torch.allclose(norm.running_var, want_v, rtol=1e-5, atol=1e-7)
    assert int(norm.num_batches_tracked) == 1


@pytest.mark.parametrize("depth", [18, 50])
def test_grid_fills_the_card_at_every_layer(depth):
    """Over R18's 20 and R50's 53 BatchNorm shapes at B=140, 256²: the
    bfloat16 layers read 16 bytes a thread, every grid has 528 blocks or
    more, each block row covers its channels once, and each thread
    keeps four rows or more."""
    shapes = bn_input_shapes(depth, 140)
    assert len(shapes) == {18: 20, 50: 53}[depth]
    for n, c, h, w in shapes:
        m, vec = n * h * w, 8
        assert c % vec == 0
        lanes, tiles, slices = BN.batchnorm_geometry(m, c, vec)
        assert lanes & (lanes - 1) == 0 and lanes <= 32
        assert tiles * lanes * vec >= c > (tiles - 1) * lanes * vec
        assert tiles * slices >= 528, (c, h, w)
        rows = BN.KERNEL_THREADS // lanes
        assert m // slices >= 4 * rows


def test_grid_of_small_and_ragged_shapes():
    assert BN.batchnorm_geometry(3 * 49, 3, 1) == (4, 1, 1)
    assert BN.batchnorm_geometry(1, 64, 8) == (8, 1, 1)
    lanes, tiles, slices = BN.batchnorm_geometry(10 ** 6, 65535, 1)
    assert (lanes, tiles) == (32, 2048) and slices >= 1


@pytest.mark.parametrize("case", ["cpu", "float16", "float64", "nchw_strided"])
def test_kernel_wrapper_refuses_before_building(case, monkeypatch):
    """The wrapper checks device, dtype and layout first: on the CPU every
    input is refused with ValueError, without asking for nvcc."""
    monkeypatch.setattr(BN.native_build, "cuda_library",
                        lambda src: pytest.fail("built the library"))
    x = torch.zeros(2, 8, 4, 4)
    x = {"cpu": x.contiguous(memory_format=torch.channels_last),
         "float16": x.half(), "float64": x.double(), "nchw_strided": x}[case]
    with pytest.raises(ValueError):
        BN.batchnorm_kernels.stats(x)
    assert BN.batchnorm_kernels.launches == 0
