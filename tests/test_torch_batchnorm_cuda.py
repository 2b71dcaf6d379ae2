"""The training-mode BatchNorm kernels (`csrc/batchnorm.cu`) on the card.

Skipped where CUDA is absent.  On an H100:
`python -m pytest --noconftest tests/test_torch_batchnorm_cuda.py -q`.

Stage by stage, each kernel against its plain PyTorch version
(`models/batchnorm.py`'s `batchnorm_*_reference`) given the kernels' own
inputs: the normalised output, the running statistics, dx and the weight's
and bias's gradients equal bit for bit (both round every product and sum
on its own, and divide truly); the channel sums agree to float32's
summation order (2e-5 of the sum of magnitudes); what follows rsqrt to
8e-7 (a few ulps: the kernels' rsqrtf and torch.rsqrt may round apart).
Then the whole Function under autograd against the plain training formula
on the card (`BatchNorm2d.plain_train_forward`), and through the data mesh
over two gloo ranks on one card against one process: at most one bfloat16
ulp (float32: 1e-5) apart on y and dx, both float32 values rounded once,
plus what the float32 statistics' summation order may move
(`torch_bn.channel_bounds`: for a channel of one value, whose variance is
rounding noise against eps, up to ~1% of r); 1e-4 of the largest on the
parameters' gradients.  A ResNet-50 training step launches the kernels
four times a layer and repeats bit for bit; launches on two streams at
once keep their own tile counters.  Every BatchNorm shape of
ResNet-18 and ResNet-50 at 18 x 256² at B=2, and ragged shapes (odd N,
7 x 7, three channels), in bfloat16 and float32, each with a constant
channel; the stages also with a channel at 1000 (the variance's clamp).
"""

import pytest
import torch

from straps_tpu_torch.models import batchnorm as BN
from torch_bn import bn_input_shapes, channel_bounds, within_bound

pytestmark = pytest.mark.cuda

CL = torch.channels_last


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


SHAPES = sorted(set(bn_input_shapes(18, 2) + bn_input_shapes(50, 2))) + [
    (3, 3, 7, 7), (3, 128, 7, 7), (1, 64, 5, 3), (5, 16, 1, 1)]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(shape, dtype, dev, seed=0, near_constant=False):
    """x with a constant channel, and with `near_constant` a channel at 1000
    spread by 1e-3, whose E[x²] - E[x]² rounds to either side of 0 (the
    clamp) and to no value of the true variance: two summation orders give
    unrelated statistics there, so only the stages, which share the
    kernels' sums, compare it."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    if c > 2:
        x[:, c // 2] = 0.7
    if c > 2 and near_constant:
        x[:, 1] = 1000.0 + 1e-3 * torch.randn((n, h, w), generator=g)
    weight = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g)
    dy = torch.randn(shape, generator=g)
    to = dict(device=dev, memory_format=CL)
    return (x.to(dtype=dtype, **to), weight.to(dev), bias.to(dev), dy.to(dtype=dtype, **to))


def _sum_close(got, x_terms, want, what):
    """Float32 sums in another order: within 2e-5 of the sum of magnitudes."""
    bound = 2e-5 * x_terms.abs().sum(dim=(0, 2, 3)).float() + 1e-30
    assert ((got - want).abs() <= bound).all(), (what, float(((got - want).abs() / bound).max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_their_plain_version(cuda, shape, dtype):
    x, weight, bias, dy = _inputs(shape, dtype, cuda, near_constant=True)
    K = BN.batchnorm_kernels
    count = x.numel() // x.shape[1]
    rm = torch.rand(shape[1], device=cuda)
    rv = torch.rand(shape[1], device=cuda) + 0.5
    rm0, rv0 = rm.clone(), rv.clone()
    tracked = torch.zeros((), dtype=torch.int64, device=cuda)
    before = K.launches

    sums = K.stats(x)
    y, stats = K.normalize(x, sums, weight, bias, rm, rv, tracked, count, 1e-5, 0.1)
    bsums, dweight, dbias = K.backward_sums(dy, x, stats)
    dx = K.backward_dx(dy, x, stats, bsums, count)
    torch.cuda.synchronize()
    assert K.launches == before + 4

    xf = x.float()
    _sum_close(sums[0], xf, BN.batchnorm_stats_reference(x.double())[0].float(), "sum x")
    _sum_close(sums[1], xf.square(), BN.batchnorm_stats_reference(x.double())[1].float(),
               "sum x^2")
    want, var = BN.batchnorm_coefficients_reference(sums, count, weight, 1e-5)
    assert torch.equal(stats[0], want[0])
    assert torch.equal(stats[3] == 0, want[3] == 0)
    for row in (1, 2, 3):
        assert torch.allclose(stats[row], want[row], rtol=8e-7, atol=0), row
    assert torch.equal(y, BN.batchnorm_normalize_reference(x, stats, bias))
    assert y.is_contiguous(memory_format=CL)
    assert torch.equal(rm, rm0 * (1.0 - 0.1) + stats[0] * 0.1)
    assert torch.equal(rv, rv0 * (1.0 - 0.1) + var * 0.1)
    assert int(tracked) == 1

    want_b = BN.batchnorm_backward_sums_reference(dy, x, stats)
    _sum_close(bsums[0], dy, want_b[0], "sum dy")
    _sum_close(bsums[1], dy.float() * (xf - stats[0][:, None, None]), want_b[1],
               "sum dy (x - mean)")
    assert torch.equal(dbias, bsums[0])
    assert torch.equal(dweight, bsums[1] * stats[2])
    assert torch.equal(dx, BN.batchnorm_backward_dx_reference(dy, x, stats, bsums, count))


def _module_run(norm, x, dy, plain):
    x = x.clone().requires_grad_(True)
    y = norm.plain_train_forward(x) if plain else norm(x)
    y.backward(dy)
    return (y.detach(), x.grad, norm.weight.grad, norm.bias.grad, norm.running_mean.clone(),
            norm.running_var.clone(), int(norm.num_batches_tracked))


def _norm(weight, bias):
    norm = BN.BatchNorm2d(weight.numel()).to(weight.device).train()
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    return norm


def _hold(got, want, dtype, x, weight):
    y, dx, dw, db, rm, rv, n = got
    y_p, dx_p, dw_p, db_p, rm_p, rv_p, n_p = want
    rel_c, abs_c = channel_bounds(x, weight)
    assert within_bound(y, y_p, dtype, rel_c, abs_c) <= 1, "y"
    # dx moves with mul (r) and with k (r²): three times r's move.
    assert within_bound(dx, dx_p, dtype, rel_c, abs_c, factor=3.0) <= 1, "dx"
    for a, b, what in ((dw, dw_p, "dweight"), (db, db_p, "dbias")):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), what
    for a, b, what in ((rm, rm_p, "running_mean"), (rv, rv_p, "running_var")):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), what
    assert n == n_p == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_function_matches_the_plain_formula_under_autograd(cuda, shape, dtype):
    x, weight, bias, dy = _inputs(shape, dtype, cuda, seed=1)
    before = BN.batchnorm_kernels.launches
    got = _module_run(_norm(weight, bias), x, dy, plain=False)
    assert BN.batchnorm_kernels.launches == before + 4
    want = _module_run(_norm(weight, bias), x, dy, plain=True)
    _hold(got, want, dtype, x, weight)


def test_other_layouts_and_dtypes(cuda):
    """The kernels refuse float16 and a contiguous (N, C, H, W) tensor; the
    module copies such a layout to channels-last first."""
    x, weight, bias, dy = _inputs((4, 64, 8, 8), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        BN.batchnorm_kernels.stats(x.half())
    with pytest.raises(ValueError):
        BN.batchnorm_kernels.stats(x.contiguous())
    got = _module_run(_norm(weight, bias), x.contiguous(), dy.contiguous(), plain=False)
    want = _module_run(_norm(weight, bias), x, dy, plain=False)
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_two_runs_repeat_bit_for_bit(cuda):
    """The stem's shape at B=16 (many row slices, the last-block sum)."""
    x, weight, bias, dy = _inputs((16, 64, 128, 128), torch.bfloat16, cuda, seed=3,
                                  near_constant=True)
    a = _module_run(_norm(weight, bias), x, dy, plain=False)
    b = _module_run(_norm(weight, bias), x, dy, plain=False)
    for u, v in zip(a, b):
        assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))


def test_two_streams_at_once_keep_their_own_counters(cuda):
    """Statistics and backward sums launched on two side streams at once,
    each on its own input, equal bit for bit those of the same inputs on
    the default stream: a stream's launches use its own tile counters."""
    K = BN.batchnorm_kernels
    shape = (16, 64, 128, 128)
    runs = [_inputs(shape, torch.bfloat16, cuda, seed=s) for s in (4, 5)]
    want = []
    for x, weight, bias, dy in runs:
        y, st = K.normalize(x, K.stats(x), weight, bias, torch.zeros(64, device=cuda),
                            torch.ones(64, device=cuda),
                            torch.zeros((), dtype=torch.int64, device=cuda),
                            x.numel() // 64, 1e-5, 0.1)
        want.append((K.stats(x), st, K.backward_sums(dy, x, st)[0]))
    streams = [torch.cuda.Stream(cuda) for _ in runs]
    torch.cuda.synchronize()
    got = [[] for _ in runs]
    for _ in range(8):
        for out, s, (x, _, _, dy), (_, st, _) in zip(got, streams, runs, want):
            with torch.cuda.stream(s):
                out.append((K.stats(x), K.backward_sums(dy, x, st)[0]))
    torch.cuda.synchronize()
    for out, (sums, _, bsums) in zip(got, want):
        for a, b in out:
            assert torch.equal(a, sums) and torch.equal(b, bsums)


def mesh_rank(x, weight, bias, dy):
    """One gloo rank on `cuda:0`: its rows of the batch through a
    BatchNorm2d over the data mesh, forward and backward."""
    from straps_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(0, "cuda:0")
    dev = mesh.device
    norm = _norm(weight.to(dev), bias.to(dev))
    xs = shard_batch(x, mesh).to(dev).contiguous(memory_format=CL).requires_grad_(True)
    with BN.use_data_mesh(norm, mesh):
        y = norm(xs)
    y.backward(shard_batch(dy, mesh).to(dev).contiguous(memory_format=CL))
    return (y.detach().cpu(), xs.grad.cpu(), norm.weight.grad.cpu(), norm.bias.grad.cpu(),
            norm.running_mean.cpu(), norm.running_var.cpu(), int(norm.num_batches_tracked),
            mesh.collectives, BN.batchnorm_kernels.launches)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_data_mesh_over_two_ranks_matches_one_process(cuda, dtype):
    """Two gloo ranks on one card, B/2 rows each: the global batch's
    statistics and gradients (the ranks' weight and bias gradients summed,
    as the train step's all-reduce does) against one process over the
    whole batch; two collectives a rank, four launches."""
    from straps_tpu_torch.parallel import launch

    x, weight, bias, dy = _inputs((6, 128, 16, 16), dtype, cuda, seed=4)
    ranks = launch(mesh_rank, 2, "cuda:0",
                   args=tuple(t.cpu() for t in (x, weight, bias, dy)), timeout_s=300)
    assert [r[7] for r in ranks] == [2, 2] and [r[8] for r in ranks] == [4, 4]
    got = (torch.cat([r[0] for r in ranks]).to(cuda), torch.cat([r[1] for r in ranks]).to(cuda),
           (ranks[0][2] + ranks[1][2]).to(cuda), (ranks[0][3] + ranks[1][3]).to(cuda),
           ranks[0][4].to(cuda), ranks[0][5].to(cuda), ranks[0][6])
    assert torch.equal(ranks[0][4], ranks[1][4]) and torch.equal(ranks[0][5], ranks[1][5])
    want = _module_run(_norm(weight, bias), x, dy, plain=False)
    _hold(got, want, dtype, x, weight)


def _r50_step(dev, seed=6):
    from straps_tpu_torch.config import TrainConfig
    from straps_tpu_torch.train.loop import build_training
    from straps_tpu_torch.train.synthetic import draw_synthetic

    cfg = TrainConfig(img_wh=64, batch_size=4, focal_length=1250.0)
    cfg.model.resnet_layers = 50
    g = torch.Generator().manual_seed(seed)
    pose = (torch.randn(4, 72, generator=g) * 0.2).to(dev)
    shape = (torch.randn(4, 10, generator=g) * 0.5).to(dev)
    _, assets, state, train_step, _ = build_training(cfg, device=dev)
    draws = draw_synthetic(torch.Generator(device=dev).manual_seed(seed), 4, assets.num_verts,
                           cfg, dev)
    return state, lambda: train_step(state, draws, pose, shape)


def test_resnet50_train_step_launches_four_a_layer_and_repeats(cuda):
    """One ResNet-50 train step (bfloat16 encoder, 64², B=4) launches the
    kernels four times for each of its 53 BatchNorm layers; two steps from
    the same state and draws (cuDNN deterministic) give bit-identical
    losses, gradients and running statistics."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            state, step = _r50_step(cuda)
            layers = sum(isinstance(m, BN.BatchNorm2d) for m in state.model.modules())
            before = BN.batchnorm_kernels.launches
            loss, tasks, _ = step()
            torch.cuda.synchronize()
            assert layers == 53
            assert BN.batchnorm_kernels.launches - before == 4 * layers
            runs.append((loss.cpu(), {k: p.grad.cpu() for k, p in
                                      state.model.named_parameters()},
                         {k: b.cpu() for k, b in state.model.named_buffers()}))
        (l1, g1, b1), (l2, g2, b2) = runs
        assert torch.equal(l1, l2)
        assert all(torch.equal(g1[k], g2[k]) for k in g1)
        assert all(torch.equal(b1[k], b2[k]) for k in b1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
