"""`tools/export_jax_checkpoint.py`: a JAX package's orbax training
checkpoint into the port's `.pt`, and both packages continuing from it.

One JAX train step (ResNet-18, 64x64, B=4, float32 encoder) on a synthetic
batch made by the port, then the JAX package's `save_checkpoint`, then the
tool.  The port's predict on the `.pt` (best parameters with the state's
BatchNorm statistics, the recorded heatmap mode) matches the JAX rollout
on the same variables to 1e-4.  Then one more step in each package on a
second batch, from the restored state: held to
`tests/test_torch_train.py::test_train_step_matches_jax`'s bounds (loss
and task losses rtol 1e-5, gradients within 2e-3 of each tensor's
largest, updated parameters atol 2e-6 where both steps' JAX gradients are
above 1e-4 of their tensor's largest, log-variances atol 1e-6, BatchNorm
statistics 1e-4 of the largest).  Adam's second update depends on the
first step's moments: from a fresh Adam the parameters would move by
about lr = 1e-4 each, fifty times the bound.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from straps_tpu.config import TrainConfig as JaxTrainConfig
from straps_tpu.losses import init_loss_log_vars as jax_log_vars
from straps_tpu.models import build_regressor as jax_build
from straps_tpu.predict.pipeline import make_predict_fn as jax_predict_fn
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu.train.state import TrainState as JaxTrainState
from straps_tpu.train.state import make_optimizer as jax_optimizer
from straps_tpu.train.step import _forward_and_dicts as jax_forward_and_dicts
from straps_tpu.train.synthetic import SyntheticBatch as JaxSyntheticBatch
from straps_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.models.convert import flax_to_torch_state_dict
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.train.loop import build_training
from straps_tpu_torch.train.step import train_on_batch
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
from straps_tpu_torch.utils.checkpoints import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B, LR = 64, 4, 1e-4
TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "export_jax_checkpoint.py"
OVERRIDES = [f"img_wh={IMG}", f"batch_size={B}", "focal_length=1250.0", f"lr={LR}",
             "model.compute_dtype=None"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load_tool():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(tassets, cfg, seed):
    rng = np.random.RandomState(seed)
    pose = torch.tensor((rng.randn(B, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(B, 10) * 0.5).astype(np.float32))
    draws = draw_synthetic(torch.Generator().manual_seed(seed), B, tassets.num_verts, cfg, "cpu")
    tbatch = generate_synthetic_batch(draws, pose, shape, tassets, cfg)
    return tbatch, JaxSyntheticBatch(*(jnp.asarray(x.numpy()) for x in tbatch))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX run's state after one step and its orbax checkpoint, the
    tool's `.pt`, the JAX step function and the port's config."""
    tmp = tmp_path_factory.mktemp("orbax")
    jassets = load_synthetic_assets()
    tassets = torch_assets(device="cpu")
    jcfg = JaxTrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, lr=LR)
    jcfg.model.compute_dtype = None
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, lr=LR)
    cfg.model.compute_dtype = None
    model = jax_build(jassets.mean_pose_6d, jassets.mean_shape, compute_dtype=None)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 18)), train=False))(
        jax.random.PRNGKey(0))
    tx = jax_optimizer(LR)

    @jax.jit
    def jstep(params, batch_stats, lv, opt_state, batch):
        def loss_fn(trainable):
            return jax_forward_and_dicts(model, trainable[0], batch_stats, trainable[1],
                                         batch, jassets, jcfg, train=True)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)((params, lv))
        updates, opt_state = tx.update(grads, opt_state, (params, lv))
        params, lv = optax.apply_updates((params, lv), updates)
        return loss, aux[0], grads, params, lv, aux[4], opt_state

    params, bs = variables["params"], variables["batch_stats"]
    lv = jax_log_vars(jcfg.losses_on, jcfg.init_loss_weights)
    _, _, grads1, params, lv, bs, opt_state = jstep(params, bs, lv, tx.init((params, lv)),
                                                    _batch(tassets, cfg, 1)[1])
    state = JaxTrainState(params=params, batch_stats=bs, log_vars=lv, opt_state=opt_state,
                          step=jnp.asarray(1, jnp.int32))
    ckpt_dir = str(tmp / "straps_model_checkpoint_epoch0")
    metrics = {"pves_pa": 0.25, "mpjpes_pa": 0.125}
    jax_save_checkpoint(ckpt_dir, state, epoch=0, best_epoch=0, best_params=params,
                        best_epoch_val_metrics=metrics, heatmap_mode="legacy")
    out = str(tmp / "from_jax.pt")
    _load_tool().main([ckpt_dir, out] + OVERRIDES)
    return {"state": state, "grads1": grads1, "out": out, "jstep": jstep, "model": model,
            "jassets": jassets, "tassets": tassets, "cfg": cfg, "metrics": metrics}


def test_export_writes_the_port_checkpoint(exported):
    ckpt = load_checkpoint(exported["out"])            # torch.load(weights_only=True)
    state = exported["state"]
    assert (ckpt["epoch"], ckpt["best_epoch"]) == (0, 0)
    assert ckpt["meta"] == {"heatmap_mode": "legacy"}
    assert ckpt["best_epoch_val_metrics"] == exported["metrics"]
    assert ckpt["state"]["step"] == 1
    assert list(ckpt["state"]["log_vars"]) == list(TrainConfig().losses_on)
    opt = ckpt["state"]["optimizer"]["state"]
    assert len(opt) == len(ckpt["best_params"]) + len(TrainConfig().losses_on)
    assert all(float(s["step"]) == 1.0 for s in opt.values())
    want = flax_to_torch_state_dict({"params": _np(state.params)})
    for k, v in want.items():
        assert np.array_equal(ckpt["best_params"][k].numpy(), v), k


def test_predict_on_exported_checkpoint_matches_jax(exported):
    state, tassets = exported["state"], exported["tassets"]
    cfg = PredictConfig(checkpoint=exported["out"], img_wh=IMG)
    cfg.model.compute_dtype = None
    model, mode = TP.load_regressor_variables(cfg, tassets, device="cpu")
    assert mode == "legacy"
    rng = np.random.RandomState(5)
    proxies = rng.rand(3, IMG, IMG, 18).astype(np.float32)
    proxies[..., 0] = proxies[..., 0] > 0.5
    got = TP.make_predict_fn(model, tassets, IMG)(torch.as_tensor(proxies))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = jax_predict_fn(exported["model"], variables, exported["jassets"],
                          IMG)(jnp.asarray(proxies))
    for key in ("cam_wp", "shape", "pose_rotmats", "verts", "reposed_verts", "joints3d_all"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_step_from_exported_state_matches_jax(exported):
    """The next step in each package from the restored state (the port's
    `train` resume path: `TrainState.load_state_dict` of the `.pt`)."""
    state, cfg, tassets = exported["state"], exported["cfg"], exported["tassets"]
    _, _, tstate, _, _ = build_training(cfg, tassets, device="cpu")
    tstate.load_state_dict(load_checkpoint(exported["out"])["state"])
    tbatch, jbatch = _batch(tassets, cfg, 2)
    loss, task_losses, _ = train_on_batch(tstate, tbatch, tassets, cfg)
    jloss, jtask, jgrads, params, lv, bs, _ = exported["jstep"](
        state.params, state.batch_stats, state.log_vars, state.opt_state, jbatch)
    assert tstate.step == 2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, v in jtask.items():
        np.testing.assert_allclose(float(task_losses[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    named = dict(tstate.model.named_parameters())
    grads = flax_to_torch_state_dict({"params": _np(jgrads[0])})
    grads1 = flax_to_torch_state_dict({"params": _np(exported["grads1"][0])})
    new_params = flax_to_torch_state_dict({"params": _np(params)})
    old_params = flax_to_torch_state_dict({"params": _np(state.params)})
    moved = 0.0
    for k, g in grads.items():
        scale = np.abs(g).max()
        assert np.abs(named[k].grad.numpy() - g).max() <= 2e-3 * scale, k
        big = (np.abs(g) > 1e-4 * scale) & (np.abs(grads1[k]) > 1e-4 * np.abs(grads1[k]).max())
        assert np.abs(named[k].detach().numpy() - new_params[k])[big].max() <= 2e-6, k
        moved = max(moved, float(np.abs(new_params[k] - old_params[k])[big].max()))
    assert moved > 5e-5
    for k, v in tstate.log_vars.items():
        assert abs(float(v.detach()) - float(lv[k])) <= 1e-6, k
    buffers = dict(tstate.model.named_buffers())
    for k, want in flax_to_torch_state_dict({"batch_stats": _np(bs)}).items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(buffers[k].numpy() - want).max() <= 1e-4 * np.abs(want).max(), k
