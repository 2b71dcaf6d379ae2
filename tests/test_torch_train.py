"""The PyTorch port's training path: the train step against the JAX
package's on the same state and batch, BatchNorm in train mode, the loss,
the tracker, and port-only mirrors of `tests/test_train.py` (a step, an
overfit run, the loop with checkpoint and resume, the validation tail and
the final-epoch checkpoint), the CLI, and predict on the port's own
training checkpoint.

Train-step parity (64x64, B=4, float32 encoder, lr 1e-4): the JAX state
(`model.init`, whose lecun-normal `fc3` moves the IEF estimate away from
the synthetic fixture's degenerate mean pose) is carried across by
`train_state_from_flax`, and one synthetic batch is converted and handed
to both steps, so nothing is rendered twice.  Loss and task losses rtol 1e-5 (task losses
with atol 1e-6: the joints2D loss may be ~0.07); gradients per
tensor within 2e-3 of the tensor's largest gradient; updated parameters
atol 2e-6 wherever the JAX gradient is above 1e-4 of its tensor's largest
(Adam's first step moves each element by about lr whatever its size, so a
tiny gradient of the other sign would flip it by 2 lr); log-variances atol
1e-6; BatchNorm running statistics within 1e-4 of each tensor's largest
magnitude.  A second step on the same batch, from the port's parameters
on both sides and each side's own Adam moments and statistics, is held to
the same bounds (its updated parameters where both steps' JAX gradients
are above 1e-4 of their tensor's largest).
"""

import dataclasses
import os
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from straps_tpu.config import TrainConfig as JaxTrainConfig
from straps_tpu.config import load_config as jax_load_config
from straps_tpu.losses import init_loss_log_vars as jax_log_vars
from straps_tpu.losses import multi_task_loss as jax_multi_task_loss
from straps_tpu.metrics.tracker import TrainingTracker as JaxTracker
from straps_tpu.models import build_regressor as jax_build
from straps_tpu.models.convert import torch_state_dict_to_flax
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu.train.state import make_optimizer as jax_optimizer
from straps_tpu.train.step import _forward_and_dicts as jax_forward_and_dicts
from straps_tpu.train.synthetic import SyntheticBatch as JaxSyntheticBatch
from straps_tpu_torch.cli import run_train
from straps_tpu_torch.config import PredictConfig, TrainConfig, load_config
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.losses.multi_task import init_loss_log_vars, multi_task_loss
from straps_tpu_torch.metrics.tracker import TrainingTracker
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, train_state_from_flax
from straps_tpu_torch.models.regressor import build_regressor
from straps_tpu_torch.models.resnet import BatchNorm2d
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.train.loop import build_training, train
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
from straps_tpu_torch.train.step import train_on_batch
from straps_tpu_torch.utils.checkpoints import checkpoint_path, load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, B, LR = 64, 4, 1e-4


@pytest.fixture(scope="module")
def tassets():
    return torch_assets(device="cpu")


# -- parity with the JAX train step -----------------------------------------

@pytest.fixture(scope="module")
def jax_step_setup(tassets):
    jassets = load_synthetic_assets()
    jcfg = JaxTrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    jcfg.model.compute_dtype = None
    model = jax_build(jassets.mean_pose_6d, jassets.mean_shape, compute_dtype=None)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 18)), train=False))(
        jax.random.PRNGKey(0))
    log_vars = jax_log_vars(jcfg.losses_on, jcfg.init_loss_weights)
    # One augmented batch, made once (by the port, whose batch
    # tests/test_torch_augment.py holds to the JAX package's) and handed
    # to both steps.
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0)
    pose, shape = _pose_shape(B)
    draws = draw_synthetic(torch.Generator().manual_seed(1), B, tassets.num_verts, cfg, "cpu")
    tbatch = generate_synthetic_batch(draws, pose, shape, tassets, cfg)
    batch = JaxSyntheticBatch(*(jnp.asarray(x.numpy()) for x in tbatch))
    tx = jax_optimizer(LR)

    @jax.jit
    def step(params, batch_stats, lv, opt_state, batch):
        def loss_fn(trainable):
            return jax_forward_and_dicts(model, trainable[0], batch_stats, trainable[1],
                                         batch, jassets, jcfg, train=True)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)((params, lv))
        updates, opt_state = tx.update(grads, opt_state, (params, lv))
        params, lv = optax.apply_updates((params, lv), updates)
        return loss, aux[0], grads, params, lv, aux[4], opt_state

    return model, variables, log_vars, (tbatch, batch), tx, step


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_train_step_matches_jax(jax_step_setup, tassets):
    _, variables, log_vars, (tbatch, jbatch), tx, jstep = jax_step_setup
    cfg = TrainConfig(img_wh=IMG, batch_size=B, focal_length=1250.0, lr=LR)
    cfg.model.compute_dtype = None
    model = build_regressor(tassets.mean_pose_6d, tassets.mean_shape, compute_dtype=None)
    state = train_state_from_flax(_np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]),
                                  _np_tree(log_vars), model, LR)
    params, bs, lv = variables["params"], variables["batch_stats"], log_vars
    opt_state = tx.init((params, lv))
    worst, prev_grads = {}, None
    for step in range(2):
        loss, task_losses, per_frame = train_on_batch(state, tbatch, tassets, cfg)
        jloss, jtask, jgrads, params, lv, bs, opt_state = jstep(params, bs, lv, opt_state, jbatch)

        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for k, v in jtask.items():
            np.testing.assert_allclose(float(task_losses[k]), float(v), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            worst["loss"] = max(worst.get("loss", 0.0), abs(float(task_losses[k]) / float(v) - 1))
        assert all(torch.isfinite(v).all() for v in per_frame.values())

        named = dict(state.model.named_parameters())
        grads = flax_to_torch_state_dict({"params": _np_tree(jgrads[0])})
        new_params = flax_to_torch_state_dict({"params": _np_tree(params)})
        assert set(grads) == set(named)
        for k, g in grads.items():
            scale = np.abs(g).max()
            d = np.abs(named[k].grad.numpy() - g).max()
            worst["grad"] = max(worst.get("grad", 0.0), d / scale)
            assert d <= 2e-3 * scale, (k, d, scale)
            big = np.abs(g) > 1e-4 * scale
            if step:
                big &= np.abs(prev_grads[k]) > 1e-4 * np.abs(prev_grads[k]).max()
            d = np.abs(named[k].detach().numpy() - new_params[k])[big].max()
            worst["param"] = max(worst.get("param", 0.0), d)
            assert d <= 2e-6, (k, d)
        for k, v in state.log_vars.items():
            g, jg = float(v.grad), float(jgrads[1][k])
            assert abs(g - jg) <= 2e-3 * abs(jg), (k, g, jg)
            assert abs(float(v.detach()) - float(lv[k])) <= 1e-6, k
        stats = flax_to_torch_state_dict({"batch_stats": _np_tree(bs)})
        buffers = dict(state.model.named_buffers())
        for k, want in stats.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = np.abs(buffers[k].numpy() - want).max() / np.abs(want).max()
            worst["bn"] = max(worst.get("bn", 0.0), d)
            assert d <= 1e-4, (k, d)
        # The next step starts both sides from the port's parameters: an
        # element whose gradient is near zero may have stepped by lr with
        # the other sign, and the next forward would see it.
        prev_grads = grads
        params = torch_state_dict_to_flax(
            {k: v.detach().numpy().copy() for k, v in named.items()})["params"]
    assert state.step == 2
    print(f"train step vs JAX, worst: {worst}")


def test_batchnorm_train_mode_matches_flax(jax_step_setup, tassets):
    """Regressor outputs and updated running statistics in train mode; the
    running variance takes the biased batch variance (torch's own update
    would be 16/15 of it here: layer4 is 2x2 at 64x64, B=4)."""
    jmodel, variables = jax_step_setup[:2]
    x = np.random.RandomState(3).rand(B, IMG, IMG, 18).astype(np.float32)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = build_regressor(tassets.mean_pose_6d, tassets.mean_shape, compute_dtype=None)
    train_state_from_flax(_np_tree(variables["params"]), _np_tree(variables["batch_stats"]),
                          {}, model, LR)
    model.train()
    got = model(torch.as_tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4)
    buffers = dict(model.named_buffers())
    for k, w in flax_to_torch_state_dict({"batch_stats": _np_tree(mutated["batch_stats"])}).items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(buffers[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert int(buffers["image_encoder.bn1.num_batches_tracked"]) == 1

    # A bfloat16 input (the encoder under autocast): float32 running
    # statistics as flax's BatchNorm(dtype=bfloat16) keeps them, and a
    # bfloat16 output within one bfloat16 rounding of flax's.
    rng = np.random.RandomState(4)
    h = (rng.randn(B, 8, 8, 16) * 2.0 + rng.randn(16)).astype(np.float32)
    h16 = jnp.asarray(h, jnp.bfloat16)
    scale, bias = rng.rand(16).astype(np.float32) + 0.5, rng.randn(16).astype(np.float32)
    fbn = flax.linen.BatchNorm(epsilon=1e-5, momentum=0.9, dtype=jnp.bfloat16,
                               use_running_average=False)
    fvars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.zeros(16), "var": jnp.ones(16)}}
    want, mutated = fbn.apply(fvars, h16, mutable=["batch_stats"])
    bn = BatchNorm2d(16, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
    x16 = torch.tensor(np.asarray(h16.astype(jnp.float32))).permute(0, 3, 1, 2)
    got = bn.train()(x16.to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)
    for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][leaf]), rtol=1e-6,
                                   err_msg=name)


def test_multi_task_loss_matches_jax():
    rng = np.random.RandomState(4)
    shapes = {"verts": (B, 30, 3), "joints2D": (B, 17, 2), "joints3D": (B, 14, 3),
              "pose_params_rot_matrices": (B, 24, 3, 3), "shape_params": (B, 10),
              "silhouettes": (B, 16, 16)}
    preds = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    labels = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    labels["joints2D"] = rng.uniform(-5, IMG + 5, (B, 17, 2)).astype(np.float32)
    labels["vis"] = rng.rand(B, 17) > 0.3
    cfg = TrainConfig(losses_on=TrainConfig().losses_on + ("silhouette",))
    cfg.init_loss_weights["silhouette"] = 0.5
    jlv = jax_log_vars(cfg.losses_on, cfg.init_loss_weights)
    tlv = init_loss_log_vars(cfg.losses_on, cfg.init_loss_weights)
    for k in cfg.losses_on:
        assert float(tlv[k].detach()) == float(jlv[k]) and tlv[k].requires_grad
    want, want_tasks = jax_multi_task_loss(jlv, {k: jnp.asarray(v) for k, v in labels.items()},
                                           {k: jnp.asarray(v) for k, v in preds.items()}, IMG)
    got, got_tasks = multi_task_loss(tlv, {k: torch.as_tensor(v) for k, v in labels.items()},
                                     {k: torch.as_tensor(v) for k, v in preds.items()}, IMG)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert set(got_tasks) == set(cfg.losses_on)
    for k in cfg.losses_on:
        np.testing.assert_allclose(float(got_tasks[k].detach()), float(want_tasks[k]), rtol=1e-6)


def test_train_config_matches_jax(tmp_path):
    """Every field of the JAX package's TrainConfig has the same default in
    the port (`render` and `smpl_precision` included, which the port
    accepts and ignores); YAML then `key=value` overrides load as the JAX
    package's `load_config` loads them."""
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    path = tmp_path / "cfg.yaml"
    path.write_text("batch_size: 8\nmodel:\n  compute_dtype: null\n"
                    "proxy_augment:\n  occlude_box_dim: 12\n")
    overrides = ["lr=0.001", "cam_augment.delta_z_range=(-1.0, 1.0)"]
    got = load_config(TrainConfig, str(path), overrides)
    want = jax_load_config(JaxTrainConfig, str(path), overrides)
    assert (got.batch_size, got.lr, got.model.compute_dtype, got.proxy_augment.occlude_box_dim,
            got.cam_augment.delta_z_range) == (8, 0.001, None, 12, (-1.0, 1.0))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_tracker_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    losses, metrics = ("verts", "joints2D"), ("pves", "pves_pa", "mpjpes_pa")
    trackers = [cls(losses, metrics, str(tmp_path / f"{name}.pkl"))
                for cls, name in ((TrainingTracker, "t"), (JaxTracker, "j"))]
    decisions = []
    for epoch in range(3):
        for t in trackers:
            t.initialise_loss_metric_sums()
        for split, n in (("train", 8), ("train", 8), ("val", 5)):
            loss = float(rng.rand())
            task = {k: float(rng.rand()) for k in losses}
            per_frame = {m: rng.rand(n).astype(np.float32) for m in metrics}
            for t in trackers:
                t.update_per_batch(split, loss, task, per_frame, n)
        best = {m: 0.5 for m in ("pves_pa", "mpjpes_pa")}
        for t in trackers:
            t.update_per_epoch()
        decisions.append([t.determine_save_model_weights_this_epoch(tuple(best), best)
                          for t in trackers])
    assert trackers[0].history == trackers[1].history
    assert all(a == b for a, b in decisions)
    with open(tmp_path / "t.pkl", "rb") as f:
        assert pickle.load(f) == trackers[1].history
    resumed = [cls(losses, metrics, str(tmp_path / f"{name}.pkl"), load_logs=True,
                   current_epoch=2) for cls, name in ((TrainingTracker, "t"), (JaxTracker, "j"))]
    assert resumed[0].history == resumed[1].history
    assert len(resumed[0].history["train_losses"]) == 2


# -- port-only mirrors of tests/test_train.py --------------------------------

def tiny_config(tmp_path, batch_size=4) -> TrainConfig:
    cfg = TrainConfig(img_wh=IMG, batch_size=batch_size, focal_length=1250.0,
                      num_epochs=1, epochs_per_save=1)
    cfg.train_path = write_synthetic_corpus(str(tmp_path / "train.npz"), n=8)
    cfg.val_path = write_synthetic_corpus(str(tmp_path / "val.npz"), n=8, seed=1)
    cfg.model_save_path = str(tmp_path / "ckpt" / "model")
    cfg.log_path = str(tmp_path / "logs" / "log.pkl")
    cfg.metrics_to_track = ("pves", "pves_pa", "mpjpes_pa", "shape_mses")
    return cfg


def _pose_shape(n, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.tensor((rng.randn(n, 72) * 0.2).astype(np.float32)),
            torch.tensor((rng.randn(n, 10) * 0.5).astype(np.float32)))


def test_single_step_updates_params_and_nothing_nan(tmp_path, tassets):
    cfg = tiny_config(tmp_path)
    model, assets, state, train_step, _ = build_training(cfg, tassets, device="cpu")
    pose, shape = _pose_shape(cfg.batch_size)
    before = next(model.parameters()).detach().clone()
    lv_before = float(state.log_vars["verts"].detach())
    draws = draw_synthetic(torch.Generator().manual_seed(0), cfg.batch_size,
                           assets.num_verts, cfg, "cpu")
    loss, task_losses, per_frame = train_step(state, draws, pose, shape)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(v) for v in task_losses.values())
    for m in cfg.metrics_to_track:
        assert torch.isfinite(per_frame[m]).all() and per_frame[m].shape == (cfg.batch_size,), m
    assert not torch.allclose(before, next(model.parameters()))
    assert float(state.log_vars["verts"].detach()) != lv_before
    assert state.step == 1


def test_loss_decreases_over_steps(tmp_path, tassets):
    """Overfit check: repeated steps on one batch with the same draws reduce
    the loss.  At the default lr 1e-4: the JAX test's 1e-3 overshoots on the
    JAX package's own init too (its loss goes 8.6 -> 299 on the second step
    and back)."""
    cfg = tiny_config(tmp_path)
    _, assets, state, train_step, _ = build_training(cfg, tassets, device="cpu")
    pose, shape = _pose_shape(cfg.batch_size)
    losses = []
    for _ in range(8):
        draws = draw_synthetic(torch.Generator().manual_seed(42), cfg.batch_size,
                               assets.num_verts, cfg, "cpu")
        losses.append(float(train_step(state, draws, pose, shape)[0]))
    assert losses[-1] < losses[0], losses


def test_full_loop_with_checkpoint_and_resume(tmp_path, tassets):
    cfg = tiny_config(tmp_path)
    cfg.num_epochs = 2
    _, _, tracker = train(cfg, assets=tassets, max_steps_per_epoch=1, verbose=False,
                          device="cpu")
    assert len(tracker.history["train_losses"]) == 2
    assert len(tracker.history["val_pves_pa"]) == 2
    assert os.path.isfile(checkpoint_path(cfg.model_save_path, 1))

    cfg2 = tiny_config(tmp_path)
    cfg2.num_epochs = 3
    cfg2.resume_from_epoch = 1
    state2, _, tracker2 = train(cfg2, assets=tassets, max_steps_per_epoch=1, verbose=False,
                                device="cpu")
    assert len(tracker2.history["train_losses"]) == 3
    assert tracker2.history["train_losses"][:2] == tracker.history["train_losses"][:2]
    assert state2.step == 3


def test_resume_keeps_the_configured_learning_rate(tmp_path, tassets):
    """A state restored from a checkpoint takes its Adam moments and step
    from it but keeps its own learning rate, as the JAX loop's resume
    builds its optimizer from `cfg.lr`."""
    cfg = tiny_config(tmp_path)
    cfg.lr = 1e-3
    _, _, saved, train_step, _ = build_training(cfg, assets=tassets, device="cpu")
    draws = draw_synthetic(torch.Generator().manual_seed(0), B, tassets.num_verts, cfg, "cpu")
    train_step(saved, draws, torch.zeros(B, 72), torch.zeros(B, 10))
    cfg.lr = 2e-5
    state = build_training(cfg, assets=tassets, device="cpu")[2]
    state.load_state_dict(saved.state_dict())
    assert [g["lr"] for g in state.optimizer.param_groups] == [2e-5]
    assert state.step == 1 and state.digest() == saved.digest()
    moments = state.optimizer.state_dict()["state"]
    for i, v in saved.optimizer.state_dict()["state"].items():
        assert torch.equal(moments[i]["exp_avg_sq"], v["exp_avg_sq"]), i


def test_small_val_set_and_final_epoch_checkpoint(tmp_path, tassets):
    """A val set smaller than the batch gives finite metrics of its real
    samples, and the final epoch is saved off the `epochs_per_save`
    boundary; the checkpoint reads back with `weights_only=True`."""
    cfg = tiny_config(tmp_path)
    cfg.val_path = write_synthetic_corpus(str(tmp_path / "val_small.npz"), n=3, seed=9)
    cfg.num_epochs = 2
    cfg.epochs_per_save = 5
    state, best_params, tracker = train(cfg, assets=tassets, max_steps_per_epoch=1,
                                        verbose=False, device="cpu")
    for m in cfg.save_val_metrics:
        vals = tracker.history[f"val_{m}"]
        assert len(vals) == 2 and np.isfinite(vals).all(), (m, vals)
    ckpt = load_checkpoint(checkpoint_path(cfg.model_save_path, 1))
    assert ckpt["epoch"] == 1 and ckpt["meta"] == {"heatmap_mode": "clean"}
    assert set(ckpt["best_params"]) == set(dict(state.model.named_parameters()))
    assert set(ckpt["state"]["log_vars"]) == set(cfg.losses_on)
    assert ckpt["state"]["step"] == 2


def test_cli_then_predict_reads_the_checkpoint(tmp_path, monkeypatch, capsys):
    """The train CLI on the CPU writes a checkpoint and finite values;
    predict reads it: best parameters with the state's BatchNorm
    statistics, and 'auto' resolves to the heatmap mode it was trained on."""
    monkeypatch.chdir(tmp_path)
    img = 32          # the corpora are 64 + 32 samples whatever the batch
    state, best_params, tracker = run_train.main([
        "--synthetic-data", "--device", "cpu", f"img_wh={img}", "batch_size=16",
        "focal_length=625.0", "num_epochs=1", "heatmap_mode='legacy'"])
    out = capsys.readouterr().out
    assert "epoch 0: train_loss=" in out and "Training completed" in out
    assert os.path.isfile("logs/synthetic_train.npz")
    assert all(np.isfinite(v[-1]) for v in tracker.history.values() if v)
    ckpt_file = checkpoint_path(TrainConfig().model_save_path, 0)
    assert os.path.isfile(ckpt_file)

    cfg = PredictConfig(checkpoint=ckpt_file, img_wh=img)
    assets = torch_assets(device="cpu")
    model, mode = TP.load_regressor_variables(cfg, assets, device="cpu")
    assert mode == "legacy"
    got = model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(got[k], best_params.get(k, v)), k
    proxy = torch.zeros(2, img, img, 18)
    proxy[:, 8:24, 12:20, 0] = 1.0
    pred = TP.make_predict_fn(model, assets, img)(proxy)
    assert torch.isfinite(pred["verts"]).all()
