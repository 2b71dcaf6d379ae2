"""The port's ResNet encoder family against the JAX package's on the same
weights: ResNet-34 (BasicBlock), ResNet-50 and -101 (Bottleneck, striding
in the 3x3), ResNeXt-50 32x4d (grouped 3x3) and wide ResNet-50-2, and the
regressor at every depth.

The flax variables get random BatchNorm scales and shifts, then running
statistics equal to the input's batch statistics (read back from a
train-mode apply), so that activations stay of order 1 through every
block.  The last BatchNorm of each residual branch scales by 0.05-0.25:
with scales near 1 the random deep networks are chaotic, and the JAX
model's own features move by 8e-4 (ResNet-50) and 4e-3 (ResNet-101) when
its input moves by one ulp, which drowns any comparison of two
implementations that round in different places.

In eval mode the pooled features and the regressor's cam/pose/shape agree
to atol 1e-4 at float32 (convolutions sum in another order).  With the
bfloat16 encoder both sides round at different places, and the JAX
bfloat16 outputs lie 0.08-0.2 from their own float32 outputs at these
depths (features of order 3; flax's BatchNorm computes in bfloat16, the
port's in float32): the port's bfloat16 outputs lie within that distance
of the JAX bfloat16 outputs, and at most 1.5x as far from the float32
outputs.  One train-mode forward (flax's BatchNorm, momentum 0.9) gives
the same features to atol 1e-4 and running statistics within 1e-4 of each
tensor's largest magnitude.  The state dict round-trips to the flax
variables exactly, and `count_parameters` equals the JAX count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.models import build_regressor as jax_build
from straps_tpu.models import resnet as jax_resnet
from straps_tpu.models.convert import torch_state_dict_to_flax as jax_to_flax
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu.utils.model_utils import count_parameters as jax_count
from straps_tpu_torch.models import resnet as torch_resnet
from straps_tpu_torch.models.convert import (
    flax_to_torch_state_dict, state_dict_to_tensors, torch_state_dict_to_flax,
)
from straps_tpu_torch.models.regressor import build_regressor
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.utils.model_utils import count_parameters
from torch_gates import count_flips, record_encoder_gates, replay_encoder_gates
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B, C = 64, 4, 18
# The last BatchNorm of each residual branch.
RESIDUAL_BN = ("bn3", "bn2")
# Encoders by the JAX package's constructor names; the depths also build
# the regressor.
ARCHS = {"resnet34": 34, "resnet50": 50, "resnet101": 101,
         "resnext50_32x4d": None, "wide_resnet50_2": None}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _input(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, IMG, IMG, C).astype(np.float32)
    x[..., 0] = x[..., 0] > 0.5
    return x


def _calibrate(variables, apply_train, x, seed):
    """Random BatchNorm scales and shifts, then running statistics equal to
    the batch statistics of a train-mode apply on `x` (read back from
    flax's update `new = 0.9 old + 0.1 batch` from mean 0 and var 1)."""
    rng = np.random.RandomState(seed)

    def perturb(path, v):
        name = path[-1].key
        if name == "scale":
            lo, hi = (0.05, 0.25) if path[-2].key in RESIDUAL_BN else (0.8, 1.2)
            return rng.uniform(lo, hi, v.shape).astype(np.float32)
        if name == "bias" and "ief" not in str(path):
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        return np.asarray(v)
    variables = {"params": jax.tree_util.tree_map_with_path(perturb, variables["params"]),
                 "batch_stats": variables["batch_stats"]}
    _, mutated = apply_train(variables, jnp.asarray(x))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) - (0.9 if p[-1].key == "var" else 0.0)) / 0.1,
        mutated["batch_stats"])
    return {"params": variables["params"], "batch_stats": _np(stats)}


def arch_variables(name):
    """(name, the flax encoder's variables, the regressor's or None)."""
    depth = ARCHS[name]
    x = _input()
    if depth is None:
        enc = getattr(jax_resnet, name)()
        variables = jax.jit(lambda k: enc.init(k, jnp.asarray(x[:1]), train=False))(
            jax.random.PRNGKey(0))
        variables = _calibrate(variables, jax.jit(
            lambda v, x: enc.apply(v, x, train=True, mutable=["batch_stats"])), x, seed=1)
        return name, variables, None
    assets = load_synthetic_assets()
    model = jax_build(assets.mean_pose_6d, assets.mean_shape, resnet_layers=depth,
                      compute_dtype=None)
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(0))
    variables = _calibrate(variables, jax.jit(
        lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"])), x, seed=1)
    enc_vars = {c: variables[c]["encoder"] for c in variables}
    return name, enc_vars, variables


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    return arch_variables(request.param)


def _encoder_state(enc_vars):
    sd = flax_to_torch_state_dict({c: {"encoder": v} for c, v in enc_vars.items()})
    return {k[len("image_encoder."):]: v for k, v in state_dict_to_tensors(sd).items()}


def _torch_encoder(name, enc_vars):
    enc = getattr(torch_resnet, name)(C)
    enc.load_state_dict(_encoder_state(enc_vars), strict=True)
    return enc


def _torch_regressor(depth, variables, compute_dtype):
    tassets = torch_assets(device="cpu")
    model = build_regressor(tassets.mean_pose_6d, tassets.mean_shape, resnet_layers=depth,
                            compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_to_tensors(flax_to_torch_state_dict(variables)),
                          strict=True)
    return model


def _check(got, want_f32, want_bf16=None):
    """float32: atol 1e-4.  bfloat16: within the JAX bfloat16 output's own
    distance to its float32 output, and at most 1.5x as far from that
    float32 output as the JAX bfloat16 output is."""
    if want_bf16 is None:
        np.testing.assert_allclose(got, want_f32, atol=1e-4)
        return
    jax_err = np.abs(want_bf16 - want_f32).max()
    assert np.abs(got - want_bf16).max() <= jax_err
    assert np.abs(got - want_f32).max() <= 1.5 * jax_err


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_forward_matches_flax(arch, compute_dtype):
    """Eval mode: the encoder's pooled features and, for a depth, the
    regressor's cam/pose/shape."""
    name, enc_vars, variables = arch
    x_np = _input(2)
    x = jnp.asarray(x_np)
    dtypes = (None,) if compute_dtype is None else (None, jnp.bfloat16)
    want = [np.asarray(getattr(jax_resnet, name)().clone(dtype=d).apply(enc_vars, x,
                                                                        train=False))
            for d in dtypes]
    enc = _torch_encoder(name, enc_vars).eval()
    xt = torch.as_tensor(x_np).permute(0, 3, 1, 2)
    with torch.inference_mode(), torch.autocast("cpu", torch.bfloat16,
                                                enabled=compute_dtype is not None):
        got = enc(xt)
    assert got.dtype == torch.float32 and got.shape == want[0].shape
    assert np.abs(want[0]).max() > 0.1
    _check(got.numpy(), *want)
    if variables is None:
        return
    depth = ARCHS[name]
    assets = load_synthetic_assets()
    want = [jax_build(assets.mean_pose_6d, assets.mean_shape, resnet_layers=depth,
                      compute_dtype=d).apply(variables, x, train=False)
            for d in (None, compute_dtype)[:len(dtypes)]]
    model = _torch_regressor(depth, variables, compute_dtype).eval()
    assert model.ief_module.fc1.in_features == torch_resnet.FEATURE_DIMS[depth] + 157
    with torch.inference_mode():
        got = model(torch.as_tensor(x_np))
    for i, g in enumerate(got):
        assert g.dtype == torch.float32
        _check(g.numpy(), *(np.asarray(w[i]) for w in want))


def test_train_mode_forward_matches_flax(arch):
    """Train-mode BatchNorm: the same pooled features and updated running
    statistics (flax's biased variance, momentum 0.9)."""
    name, enc_vars, _ = arch
    x = _input(4)
    want, mutated = getattr(jax_resnet, name)().apply(enc_vars, jnp.asarray(x), train=True,
                                                       mutable=["batch_stats"])
    enc = _torch_encoder(name, enc_vars).train()
    with torch.no_grad():
        got = enc(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    buffers = dict(enc.named_buffers())
    stats = _encoder_state(_np({"batch_stats": mutated["batch_stats"]}))
    assert stats
    for k, w in stats.items():
        if not k.endswith("num_batches_tracked"):
            w = w.numpy()
            assert np.abs(buffers[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k


def test_state_dict_round_trip_is_exact(arch):
    """flax -> torch names -> flax gives the variables back bit for bit,
    as the JAX package's own inverse reads the same state dict."""
    name, enc_vars, variables = arch
    variables = variables or {c: {"encoder": v} for c, v in enc_vars.items()}
    sd = flax_to_torch_state_dict(_np(variables))
    for back in (torch_state_dict_to_flax(sd), jax_to_flax(sd)):
        want_leaves = jax.tree_util.tree_leaves_with_path(_np(variables))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want_leaves)
        for path, w in want_leaves:
            assert got[path].dtype == w.dtype and np.array_equal(got[path], w), path
    if name.startswith("resnext"):
        conv2 = sd["image_encoder.layer1.0.conv2.weight"]
        assert conv2.shape == (128, 4, 3, 3)          # width 128, 32 groups
    else:
        assert "image_encoder.layer1.0.conv2.weight" in sd


def test_count_parameters_matches_jax(arch):
    name, enc_vars, variables = arch
    params = (variables or enc_vars)["params"]
    want = jax_count(params)
    sd = flax_to_torch_state_dict(_np(variables or {c: {"encoder": v}
                                                    for c, v in enc_vars.items()}))
    assert count_parameters(sd) == want
    module = (_torch_regressor(ARCHS[name], variables, None) if variables
              else _torch_encoder(name, enc_vars))
    assert count_parameters(module) == want


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_build_regressor_every_depth(depth):
    """Every depth builds, with the IEF widths of its block family, and
    has the JAX model's parameter shapes (from `jax.eval_shape`)."""
    tassets = torch_assets(device="cpu")
    model = build_regressor(tassets.mean_pose_6d, tassets.mean_shape, resnet_layers=depth)
    width = 512 if depth < 50 else 1024
    assert (model.ief_module.fc1.out_features, model.ief_module.fc2.out_features) == (width,
                                                                                       width)
    assets = load_synthetic_assets()
    jmodel = jax_build(assets.mean_pose_6d, assets.mean_shape, resnet_layers=depth)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, C)), train=False))
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    assert count_parameters(model) == jax_count(shapes["params"])


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_replayed_encoder_selections_reproduce_the_run(name):
    """`tests/torch_gates.py` (the card's train-step checks): replaying a
    train-mode forward's own ReLU gates and max-pool indices gives the same
    features, and gradients within 1e-5 of each tensor's largest (only the
    backward's summation order changes)."""
    x = torch.as_tensor(_input(5)).permute(0, 3, 1, 2)
    runs = []
    for replay in (None, "own"):
        torch.manual_seed(0)
        enc = getattr(torch_resnet, name)(C).train()
        gates = (record_encoder_gates(enc) if replay is None
                 else replay_encoder_gates(enc, runs[0][2]))
        feats = enc(x)
        feats.square().sum().backward()
        runs.append((feats.detach(), {k: p.grad for k, p in enc.named_parameters()}, gates))
    (f0, g0, gates), (f1, g1, _) = runs
    assert count_flips(gates, gates) == 0 and len(gates) > 16
    assert torch.equal(f0, f1)
    for k, g in g0.items():
        assert (g1[k] - g).abs().max() <= 1e-5 * g.abs().max(), k
