"""The port's data-parallel train step over two gloo ranks on the CPU
(64x64, B=4, ResNet-18, float32 encoder, one torch thread a rank).

The JAX package's data-parallel step is the global-batch step
(`tests/test_train.py::test_8dev_step_matches_1dev`: loss within 1e-4,
gradients within 2e-4 of each leaf's largest).  The port's step over two
processes, each with two rows, is held to the same bounds against the
port's step in one process on the same global batches and draws, with
BatchNorm running statistics within 1e-5 of each tensor's largest and
both ranks' parameters and buffers bitwise identical after two steps; and
to `tests/test_torch_train.py::test_train_step_matches_jax`'s bounds
against the JAX step on a two-device mesh (conftest's virtual CPU
devices).  The second step is held on its losses only: after one Adam
step, parameters whose gradients lie near zero may sit ±lr apart.  The
multi-task loss with unequal visibility across the ranks equals the JAX
loss, and so do its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.losses import multi_task_loss as jax_multi_task_loss
from straps_tpu.parallel import make_mesh as jax_make_mesh
from straps_tpu.parallel import replicate as jax_replicate
from straps_tpu.parallel import shard_batch as jax_shard_batch
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, state_dict_to_tensors
from straps_tpu_torch.parallel import launch
from straps_tpu_torch.parallel.dryrun import loss_and_grads, train_steps
from straps_tpu_torch.train.synthetic import draw_synthetic
from test_torch_train import B, IMG, LR, _np_tree, jax_step_setup, tassets  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TIMEOUT_S = 120


def _cfg():
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, lr=LR)
    cfg.model.compute_dtype = None
    return cfg


@pytest.fixture(scope="module")
def global_steps(tassets):  # noqa: F811
    """Two train steps on two seeded global batches and their draws: in one
    process (no mesh) and over two ranks."""
    cfg = _cfg()
    rng = np.random.RandomState(0)
    generator = torch.Generator().manual_seed(1)
    steps = [(draw_synthetic(generator, B, tassets.num_verts, cfg, "cpu"),
              torch.tensor((rng.randn(B, 72) * 0.2).astype(np.float32)),
              torch.tensor((rng.randn(B, 10) * 0.5).astype(np.float32)))
             for _ in range(2)]
    one = train_steps(cfg, steps)
    two = launch(train_steps, 2, "cpu", args=(cfg, steps), timeout_s=TIMEOUT_S)
    return one, two


def test_two_ranks_step_is_the_global_batch_step(global_steps):
    one, two = global_steps
    want, got = one["steps"][0], two[0]["steps"][0]
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    for k, v in want["tasks"].items():
        assert abs(got["tasks"][k] - v) < 1e-4, k
    for k, v in want["per_frame"].items():
        assert got["per_frame"][k].shape == (B,)
        np.testing.assert_allclose(got["per_frame"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    for k, a in want["grads"].items():
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(got["grads"][k] / scale, a / scale, atol=2e-4, err_msg=k)
    for k, a in want["log_var_grads"].items():
        assert abs(got["log_var_grads"][k] - a) <= 2e-4 * abs(a), k
    for k, a in want["stats"].items():
        d = np.abs(got["stats"][k] - a).max() / np.abs(a).max()
        assert d <= 1e-5, (k, d)


def test_second_step_loss_stays_with_the_global_batch_step(global_steps):
    """After one Adam step the parameters whose gradients lie near zero may
    have moved by ±lr on either side (Adam's first step is lr·sign(g)), so
    the second step's gradients are not held; its losses are."""
    one, two = global_steps
    want, got = one["steps"][1], two[0]["steps"][1]
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    for k, v in want["tasks"].items():
        assert abs(got["tasks"][k] - v) < 1e-4, k


def test_replicas_are_bitwise_identical_after_two_steps(global_steps):
    _, two = global_steps
    assert two[1]["steps"] is None
    assert two[0]["digest"] == two[1]["digest"]


def test_two_ranks_step_matches_the_jax_mesh_step(jax_step_setup):  # noqa: F811
    """One step of the batch `jax_step_setup` hands both packages: the JAX
    step on a two-device mesh (batch sharded, state replicated) and the
    port's over two ranks, from the same JAX-initialised state."""
    _, variables, log_vars, (tbatch, jbatch), tx, jstep = jax_step_setup
    mesh = jax_make_mesh(2)
    assert mesh.devices.size == 2
    params, bs, lv = jax_replicate((variables["params"], variables["batch_stats"], log_vars),
                                   mesh)
    jloss, jtask, jgrads, params, lv, bs, _ = jstep(params, bs, lv, tx.init((params, lv)),
                                                     jax_shard_batch(jbatch, mesh))
    sd = state_dict_to_tensors(flax_to_torch_state_dict(_np_tree(variables)))
    got = launch(train_steps, 2, "cpu", timeout_s=TIMEOUT_S,
                 args=(_cfg(), [tbatch], (sd, _np_tree(log_vars))))[0]["steps"][0]

    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    for k, v in jtask.items():
        np.testing.assert_allclose(got["tasks"][k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    grads = flax_to_torch_state_dict({"params": _np_tree(jgrads[0])})
    new_params = flax_to_torch_state_dict({"params": _np_tree(params)})
    assert set(grads) == set(got["grads"])
    for k, g in grads.items():
        scale = np.abs(g).max()
        assert np.abs(got["grads"][k] - g).max() <= 2e-3 * scale, k
        big = np.abs(g) > 1e-4 * scale
        assert np.abs(got["params"][k] - new_params[k])[big].max() <= 2e-6, k
    for k, v in got["log_vars"].items():
        jg = float(jgrads[1][k])
        assert abs(got["log_var_grads"][k] - jg) <= 2e-3 * abs(jg), k
        assert abs(v - float(lv[k])) <= 1e-6, k
    for k, want in flax_to_torch_state_dict({"batch_stats": _np_tree(bs)}).items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(got["stats"][k] - want).max() <= 1e-4 * np.abs(want).max(), k


def test_loss_over_ranks_with_unequal_visibility_matches_jax():
    """Rank 0's rows see 3 joints each, rank 1's 15: the joints2D mean is
    over the global visible count, and the log-variance terms count once."""
    rng = np.random.RandomState(6)
    shapes = {"verts": (B, 30, 3), "joints2D": (B, 17, 2), "joints3D": (B, 14, 3),
              "pose_params_rot_matrices": (B, 24, 3, 3), "shape_params": (B, 10)}
    preds = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    labels = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    labels["joints2D"] = rng.uniform(-5, IMG + 5, (B, 17, 2)).astype(np.float32)
    labels["vis"] = np.zeros((B, 17), bool)
    labels["vis"][:2, :3] = True
    labels["vis"][2:, 2:] = True
    cfg = TrainConfig()
    log_vars = {k: np.float32(-np.log(cfg.init_loss_weights[k] + 1e-6)) for k in cfg.losses_on}

    def jax_loss(lv, pred):
        return jax_multi_task_loss(lv, {k: jnp.asarray(v) for k, v in labels.items()}, pred, IMG)
    (want, want_tasks), (want_lv, want_pred) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in log_vars.items()},
        {k: jnp.asarray(v) for k, v in preds.items()})
    got = launch(loss_and_grads, 2, "cpu", args=(log_vars, labels, preds, IMG),
                 timeout_s=TIMEOUT_S)
    assert got[0]["loss"] == got[1]["loss"]
    got = got[0]
    np.testing.assert_allclose(got["loss"], float(want), rtol=1e-6)
    for k in cfg.losses_on:
        np.testing.assert_allclose(got["tasks"][k], float(want_tasks[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["log_var_grads"][k], float(want_lv[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        key = {"pose_params": "pose_params_rot_matrices"}.get(k, k)
        np.testing.assert_allclose(got["pred_grads"][key], np.asarray(want_pred[key]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
