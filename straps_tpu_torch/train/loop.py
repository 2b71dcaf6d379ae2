"""Epoch training loop: datasets -> steps -> tracking -> checkpoints
(counterpart of `straps_tpu/train/loop.py`).

A train epoch with augmentation, a validation epoch without it over every
sample (the tail batch padded by cycling samples), metric tracking with the
all-metrics-must-improve best gate, a full-state checkpoint every
`epochs_per_save` epochs and at the final epoch, and a resume that
truncates the metric history (from the epoch's `.pt` or, where there is
none, the JAX package's orbax directory of the epoch).  The random draws
of epoch `e` come from a `torch.Generator` on the device seeded with
`seed * 100003 + e`, as the JAX loop seeds its key.

With `data_parallel_devices` ranks in a process group (`parallel.launch`)
every rank walks the same seeded permutation and draws, and steps on its
rows of each global batch (`shard_batch`, `shard_draws`); the steps return
global values, so every rank's decisions are alike.  Rank 0 alone prints
and writes the log and the checkpoints, and every rank waits for each
checkpoint; the other ranks' trackers keep this run's epochs and write
nothing.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.data.dataset import SyntheticTrainingDataset, epoch_batches
from straps_tpu_torch.losses.multi_task import init_loss_log_vars
from straps_tpu_torch.metrics.tracker import TrainingTracker
from straps_tpu_torch.models.regressor import build_regressor, init_random_weights
from straps_tpu_torch.parallel.mesh import barrier, make_mesh, shard_batch
from straps_tpu_torch.smpl.assets import load_assets
from straps_tpu_torch.train.state import TrainState, create_train_state
from straps_tpu_torch.train.step import make_train_step, make_val_step
from straps_tpu_torch.train.synthetic import draw_synthetic, shard_draws
from straps_tpu_torch.utils.checkpoints import (
    checkpoint_path, load_checkpoint, orbax_checkpoint_path, save_checkpoint,
)
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.model_utils import count_parameters
from straps_tpu_torch.utils.profiling import StepTimer, span


def build_training(cfg: TrainConfig, assets=None, device="cuda"):
    """(model, assets, state, train_step, val_step) on `device` (`cuda`
    raises without a card); the regressor gets seeded random weights
    (`init_random_weights` with `cfg.seed`).  In a process group the
    state and steps run over the data mesh of `cfg.data_parallel_devices`
    (`state.mesh`; `make_mesh`), on this rank's device."""
    dev = resolve_device(device)
    mesh = make_mesh(cfg.data_parallel_devices, dev)
    if mesh is not None:
        dev = mesh.device
    assets = load_assets(cfg.smpl_dir, device=dev) if assets is None else assets.to(dev)
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape,
                            in_channels=cfg.model.resnet_in_channels,
                            resnet_layers=cfg.model.resnet_layers,
                            ief_iters=cfg.model.ief_iters,
                            compute_dtype=cfg.model.compute_dtype)
    init_random_weights(model, torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    log_vars = init_loss_log_vars(cfg.losses_on, cfg.init_loss_weights, device=dev)
    state = create_train_state(model, log_vars, cfg.lr, mesh)
    return model, assets, state, make_train_step(assets, cfg), make_val_step(assets, cfg)


def resume_path(model_save_path: str, epoch: int) -> str:
    """The checkpoint a resume from `epoch` reads: the port's
    `<model_save_path>_epoch<N>.pt`, or, where there is none, the JAX
    package's orbax directory `<model_save_path>_epoch<N>`."""
    pt, orbax_dir = checkpoint_path(model_save_path, epoch), orbax_checkpoint_path(
        model_save_path, epoch)
    return orbax_dir if not os.path.exists(pt) and os.path.isdir(orbax_dir) else pt


def params_to_host(model) -> Dict[str, torch.Tensor]:
    """A CPU copy of the model's parameters (no BatchNorm statistics)."""
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def pull_to_host(loss, task_losses, per_frame):
    """One device->host copy of a step's loss, task losses and per-frame
    metrics -> (float, {task: float}, {metric: numpy (B,)})."""
    tasks, metrics = list(task_losses), list(per_frame)
    with span("straps.train.pull"):
        flat = torch.cat([loss.reshape(1).float()]
                         + [task_losses[k].reshape(1).float() for k in tasks]
                         + [per_frame[k].reshape(-1).float() for k in metrics]).cpu().numpy()
    B = per_frame[metrics[0]].shape[0] if metrics else 0
    n = 1 + len(tasks)
    return (float(flat[0]), {k: float(flat[1 + i]) for i, k in enumerate(tasks)},
            {k: flat[n + i * B:n + (i + 1) * B] for i, k in enumerate(metrics)})


def train(cfg: TrainConfig, assets=None, max_steps_per_epoch: Optional[int] = None,
          verbose: bool = True, device="cuda"
          ) -> Tuple[TrainState, Dict[str, torch.Tensor], TrainingTracker]:
    """Run the full training on `device` (`cuda` raises without a card);
    returns (final state, best parameters on the CPU, tracker)."""
    model, assets, state, train_step, val_step = build_training(cfg, assets, device)
    dev, mesh = assets.device, state.mesh
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    if verbose:
        print(f"regressor parameters: {count_parameters(model)} "
              f"(ResNet-{cfg.model.resnet_layers} + IEF)")

    train_ds = SyntheticTrainingDataset(cfg.train_path, cfg.params_from)
    val_ds = SyntheticTrainingDataset(cfg.val_path, cfg.params_from)

    os.makedirs(os.path.dirname(cfg.log_path) or ".", exist_ok=True)
    os.makedirs(os.path.dirname(cfg.model_save_path) or ".", exist_ok=True)

    current_epoch = 0
    best_epoch_val_metrics = {m: np.inf for m in cfg.save_val_metrics}
    best_epoch = 0
    best_params = params_to_host(model)
    load_logs = False
    if cfg.resume_from_epoch is not None:
        restored = load_checkpoint(resume_path(cfg.model_save_path, cfg.resume_from_epoch),
                                   task_order=cfg.losses_on, resume=True)
        state.load_state_dict(restored["state"])
        current_epoch = int(restored["epoch"]) + 1
        best_epoch = int(restored["best_epoch"])
        best_params = restored["best_params"]
        saved_best = restored["best_epoch_val_metrics"]
        best_epoch_val_metrics = {m: float(saved_best[m]) if m in saved_best else np.inf
                                  for m in cfg.save_val_metrics}
        load_logs = True

    tracker = TrainingTracker(cfg.losses_on, cfg.metrics_to_track,
                              cfg.log_path if lead else os.devnull,
                              load_logs=load_logs and lead, current_epoch=current_epoch)
    rng = np.random.RandomState(cfg.seed + current_epoch)
    timer = StepTimer()

    def device_batch(b):
        if mesh is not None:
            b = shard_batch(b, mesh)
        return (torch.as_tensor(b["pose"], device=dev),
                torch.as_tensor(b["shape"], device=dev))

    for epoch in range(current_epoch, cfg.num_epochs):
        tracker.initialise_loss_metric_sums()
        timer.reset()      # per-epoch means
        generator = torch.Generator(device=dev).manual_seed(cfg.seed * 100003 + epoch)

        for i, b in enumerate(epoch_batches(train_ds, cfg.batch_size, rng)):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            pose, shape = device_batch(b)
            with timer.measure("train_step"):
                draws = draw_synthetic(generator, b["pose"].shape[0], assets.num_verts, cfg,
                                       dev)
                if mesh is not None:
                    draws = shard_draws(draws, mesh)
                # The one host pull is the step's completion barrier, so it
                # belongs inside the timed block.
                loss, task_losses, per_frame = pull_to_host(
                    *train_step(state, draws, pose, shape))
            tracker.update_per_batch("train", loss, task_losses, per_frame,
                                     b["pose"].shape[0])

        # Validation covers every sample: the partial last batch is padded to
        # the batch size by cycling samples and the per-frame metrics are
        # trimmed back to the real count; its scalar losses average over the
        # cycled duplicates.
        for i, b in enumerate(epoch_batches(val_ds, cfg.batch_size, rng,
                                            shuffle=False, drop_last=False)):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            n_real = b["pose"].shape[0]
            if n_real < cfg.batch_size:
                fill = np.arange(cfg.batch_size - n_real) % n_real
                b = {k: np.concatenate([v, v[fill]]) for k, v in b.items()}
            pose, shape = device_batch(b)
            with timer.measure("val_step"):
                loss, task_losses, per_frame = pull_to_host(*val_step(state, pose, shape))
            per_frame = {k: v[:n_real] for k, v in per_frame.items()}
            tracker.update_per_batch("val", loss, task_losses, per_frame, n_real)

        tracker.update_per_epoch()
        if verbose:
            print(f"epoch {epoch}: train_loss="
                  f"{tracker.history['train_losses'][-1]:.5f} val_loss="
                  f"{tracker.history['val_losses'][-1]:.5f} "
                  + " ".join(f"val_{m}={tracker.history['val_' + m][-1]:.5f}"
                             for m in cfg.save_val_metrics)
                  + f" ({timer.summary()})")

        if tracker.determine_save_model_weights_this_epoch(
                cfg.save_val_metrics, best_epoch_val_metrics):
            for m in cfg.save_val_metrics:
                best_epoch_val_metrics[m] = tracker.history[f"val_{m}"][-1]
            best_params = params_to_host(model)
            best_epoch = epoch

        if epoch % cfg.epochs_per_save == 0 or epoch == cfg.num_epochs - 1:
            # Also at the final epoch, so that best weights found after the
            # last boundary are on disk.  The span holds the save stall: the
            # write, and every rank's wait for it.
            with span("straps.train.checkpoint"):
                if lead:
                    save_checkpoint(checkpoint_path(cfg.model_save_path, epoch), state,
                                    epoch=epoch, best_epoch=best_epoch,
                                    best_params=best_params,
                                    best_epoch_val_metrics=best_epoch_val_metrics,
                                    heatmap_mode=cfg.heatmap_mode)
                if mesh is not None:
                    barrier(mesh)

    tracker.best_epoch = best_epoch
    tracker.best_epoch_val_metrics = {k: float(v) for k, v in best_epoch_val_metrics.items()}
    return state, best_params, tracker
