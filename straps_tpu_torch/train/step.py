"""Train and validation steps (counterpart of `straps_tpu/train/step.py`).

A train step: synthetic batch (no gradients) -> regressor in train mode ->
rot6d -> SMPL on the predictions (and its soft silhouette, when the
'silhouette' task is on) -> multi-task loss -> backward -> one Adam
update of the parameters and the log-variances together -> per-frame
metrics.  Each step returns its loss, task losses and per-frame metrics as
device tensors; the caller pulls them to the host once per step, which is
the step's completion barrier.

Over a data mesh (`parallel.DataMesh`) each rank steps on its rows of the
global batch: BatchNorm takes the global statistics, the loss is the
rank's share of the global loss, and after the backward pass one SUM
all-reduce of every gradient (with the loss shares) leaves the gradient of
the global loss on every rank, so that Adam steps alike everywhere.  The
step returns the global loss and task losses and the per-frame metrics of
the global batch, gathered in global order.

On a card and without a mesh, the update's forward pass, loss, backward
pass and the per-frame metrics that a graph can hold are one CUDA graph
(`utils/native_build.py::KernelGraph`) for each batch shape (`train_on_batch`): the
first update of a shape runs eagerly, the second is captured and
replayed, every later one copies its batch into the graph's inputs and
replays it.  Adam, and the Procrustes metrics, whose solver checks its
result on the host, run eagerly after the replay.  `UPDATE_GRAPH_STATS`
counts the captures, the replays and the eager updates by reason.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from straps_tpu_torch.config import TrainConfig, check_jax_only_keys
from straps_tpu_torch.geometry.camera import orthographic_project
from straps_tpu_torch.geometry.rotations import rot6d_to_rotmat
from straps_tpu_torch.losses.multi_task import multi_task_loss
from straps_tpu_torch.metrics.compute import HOST_CHECKED_METRICS, compute_per_frame_metrics
from straps_tpu_torch.models.batchnorm import use_data_mesh
from straps_tpu_torch.parallel.mesh import all_reduce_, gather_batch
from straps_tpu_torch.render.soft_silhouette import soft_silhouette_from_wp
from straps_tpu_torch.smpl.assets import SmplAssets
from straps_tpu_torch.smpl.model import select_joint_sets, smpl_forward
from straps_tpu_torch.train.state import TrainState
from straps_tpu_torch.train.synthetic import SyntheticBatch, generate_synthetic_batch
from straps_tpu_torch.utils.native_build import KernelGraph, KeyedGraphs
from straps_tpu_torch.utils.profiling import span

StepOutput = Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]

# The updates of `train_on_batch` since the last reset, each counted once:
# captured (and replayed), replayed, or eager by reason (a data mesh, on
# the card or not; a state off the card; the first update of its key).
UPDATE_GRAPH_STATS = KeyedGraphs("first_of_shape", "cpu", "mesh")


def reset_update_graph_stats() -> None:
    """Zero every count of `UPDATE_GRAPH_STATS`."""
    UPDATE_GRAPH_STATS.reset()


def silhouette_target(proxy: torch.Tensor, wh: int) -> torch.Tensor:
    """The silhouette channel of an NHWC proxy (B, H, W, C) resized to
    (B, wh, wh) as `jax.image.resize(method="linear")` resizes it: a
    triangle filter, widened by the factor when it downscales."""
    return F.interpolate(proxy[..., 0][:, None], (wh, wh), mode="bilinear", antialias=True,
                         align_corners=False)[:, 0]


def _forward_and_dicts(state: TrainState, batch: SyntheticBatch, assets: SmplAssets,
                       cfg: TrainConfig, train: bool):
    """Regressor forward (BatchNorm in train or eval mode) + predicted SMPL
    + loss (this rank's share over `state.mesh`).  Returns (loss,
    task_losses, pred_dict, target_dict, predicted reposed vertices); the
    reposed mesh feeds only the metrics and carries no gradient."""
    model, log_vars = state.model, state.log_vars
    model.train(train)
    cam, pose6d, shape = model(batch.proxy)
    B = cam.shape[0]
    rotmats = rot6d_to_rotmat(pose6d.reshape(B, 24, 6))      # (B, 24, 3, 3)
    pred = smpl_forward(assets, shape, rotmats[:, 1:], rotmats[:, 0:1])
    with torch.no_grad():
        pred_reposed = smpl_forward(assets, shape)
    pred_h36mlsp, pred_coco = select_joint_sets(pred.joints)
    pred_joints2d = orthographic_project(pred_coco, cam)

    pred_dict = {
        "verts": pred.vertices,
        "joints2D": pred_joints2d,
        "joints3D": pred_h36mlsp,
        "pose_params_rot_matrices": rotmats,
        "shape_params": shape,
    }
    target_dict = {
        "verts": batch.target_verts,
        "joints2D": batch.target_joints2d_coco,
        "joints3D": batch.target_joints_h36mlsp,
        "pose_params_rot_matrices": batch.target_pose_rotmats,
        "shape_params": batch.target_shape,
        "vis": batch.target_vis,
    }
    if "silhouette" in log_vars:
        # The optional silhouette task: the soft silhouette of the predicted
        # mesh against the proxy's silhouette, both in the crop frame.
        wh = cfg.silhouette_loss_wh
        pred_dict["silhouettes"] = soft_silhouette_from_wp(pred.vertices, cam, wh)
        target_dict["silhouettes"] = silhouette_target(batch.proxy, wh)
    loss, task_losses = multi_task_loss(log_vars, target_dict, pred_dict, cfg.img_wh,
                                        state.mesh)
    return loss, task_losses, pred_dict, target_dict, pred_reposed.vertices


@torch.no_grad()
def _metrics(cfg: TrainConfig, pred_dict, target_dict, pred_reposed,
             batch: SyntheticBatch, names=None) -> Dict[str, torch.Tensor]:
    """The per-frame metrics `names` (default: the configuration's)."""
    names = tuple(cfg.metrics_to_track) if names is None else names
    return compute_per_frame_metrics(names, pred_dict, target_dict, cfg.img_wh,
                                     pred_reposed=pred_reposed,
                                     target_reposed=batch.target_reposed_verts)


def _global_losses(loss, task_losses, mesh, grads=()):
    """The global loss and task losses, sums of the ranks' shares; `grads`
    are summed over the ranks, in place, in the same collective."""
    values = torch.stack([loss.detach()] + [v.detach() for v in task_losses.values()])
    all_reduce_(list(grads) + [values], mesh)
    return values[0], dict(zip(task_losses, values[1:]))


def train_on_batch(state: TrainState, batch: SyntheticBatch, assets: SmplAssets,
                   cfg: TrainConfig) -> StepOutput:
    """Forward, backward and one Adam update on `batch`; `state` is updated
    in place, and each trainable's `.grad` keeps this step's gradient.
    Returns (loss, task_losses, per_frame metrics), detached, on the
    device.  Over `state.mesh`, `batch` holds this rank's rows, the
    gradients are the global loss's, and the outputs are global.

    A state on the card without a mesh replays the update's CUDA graph for
    the batch's shapes and dtypes and the configuration's tasks
    (`state.update_graphs`), captured at the second update of that key;
    the first runs eagerly, as every update off the card or over a mesh
    does.  The arithmetic is the eager update's either way."""
    with span("straps.train.update"):
        def eager():
            return _eager_update(state, batch, assets, cfg)
        if state.mesh is not None:
            return UPDATE_GRAPH_STATS.run_eager("mesh", eager)
        if not next(state.model.parameters()).is_cuda:
            return UPDATE_GRAPH_STATS.run_eager("cpu", eager)
        return UPDATE_GRAPH_STATS.call(
            state.update_graphs, _graph_key(state, batch, cfg),
            capture=lambda: _UpdateGraph(state, batch, assets, cfg),
            replay=lambda graph: graph.step(state, batch, cfg), eager=eager)


def _eager_update(state: TrainState, batch: SyntheticBatch, assets: SmplAssets,
                  cfg: TrainConfig) -> StepOutput:
    """`train_on_batch`'s update op by op, each stage in its span."""
    mesh = state.mesh
    state.optimizer.zero_grad(set_to_none=True)
    with span("straps.update.forward"), use_data_mesh(state.model, mesh):
        loss, task_losses, pred_dict, target_dict, pred_reposed = _forward_and_dicts(
            state, batch, assets, cfg, train=True)
    with span("straps.update.backward"):
        loss.backward()
        if mesh is not None:
            trainables = list(state.model.parameters()) + list(state.log_vars.values())
            loss, task_losses = _global_losses(loss, task_losses, mesh,
                                               grads=[p.grad for p in trainables])
    with span("straps.update.adam"):
        state.optimizer.step()
        state.step += 1
    with span("straps.update.metrics"):
        per_frame = _metrics(cfg, pred_dict, target_dict, pred_reposed, batch)
        if mesh is not None:
            per_frame = gather_batch(per_frame, mesh)
    return loss.detach(), {k: v.detach() for k, v in task_losses.items()}, per_frame


def _graph_key(state: TrainState, batch: SyntheticBatch, cfg: TrainConfig) -> tuple:
    """What a captured update depends on beyond the values of its inputs:
    the batch's shapes and dtypes, the tasks, the sizes and the metrics."""
    return (tuple((tuple(t.shape), t.dtype) for t in batch), tuple(state.log_vars),
            cfg.img_wh, cfg.silhouette_loss_wh, tuple(cfg.metrics_to_track))


class _UpdateGraph:
    """The forward pass, loss, backward pass and graph-safe per-frame
    metrics of one key, captured on a side stream.  Its inputs are a copy
    of the batch it was captured with; its outputs, and the trainables'
    `.grad` tensors it writes, keep their memory from replay to replay."""

    def __init__(self, state: TrainState, batch: SyntheticBatch, assets: SmplAssets,
                 cfg: TrainConfig):
        names = tuple(cfg.metrics_to_track)
        self.solved = tuple(m for m in names if m in HOST_CHECKED_METRICS)
        captured = tuple(m for m in names if m not in HOST_CHECKED_METRICS)
        self.inputs = SyntheticBatch(*(t.clone() for t in batch))
        # Gradients made by the capture, in the graph's memory.
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = KernelGraph()
        with self.graph.capture():
            loss, task_losses, pred_dict, target_dict, pred_reposed = _forward_and_dicts(
                state, self.inputs, assets, cfg, train=True)
            loss.backward()
            frames = _metrics(cfg, pred_dict, target_dict, pred_reposed, self.inputs, captured)
            # Every output in one tensor, copied out once a replay.
            self.flat = torch.cat([loss.detach().reshape(1)]
                                  + [v.detach().reshape(1) for v in task_losses.values()]
                                  + [v.reshape(-1) for v in frames.values()])
        self.tasks, self.frames = list(task_losses), list(frames)
        self.dicts = ({k: v.detach() for k, v in pred_dict.items()}, target_dict,
                      pred_reposed)
        self.trainables = list(state.model.parameters()) + list(state.log_vars.values())
        self.grads = [p.grad for p in self.trainables]

    def step(self, state: TrainState, batch: SyntheticBatch, cfg: TrainConfig) -> StepOutput:
        """`batch` into the inputs, the replay, Adam, the Procrustes metrics."""
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src)
        # An eager update since the last replay (another key's first) set new `.grad`s.
        if any(p.grad is not g for p, g in zip(self.trainables, self.grads)):
            for p, g in zip(self.trainables, self.grads):
                p.grad = g
        state.model.train(True)
        self.graph.replay()
        state.optimizer.step()
        state.step += 1
        flat = self.flat.clone()
        n, B = 1 + len(self.tasks), self.inputs.proxy.shape[0]
        per_frame = {k: flat[n + i * B:n + (i + 1) * B] for i, k in enumerate(self.frames)}
        per_frame.update(_metrics(cfg, *self.dicts, self.inputs, self.solved))
        return flat[0], dict(zip(self.tasks, flat[1:n])), per_frame


def make_train_step(assets: SmplAssets, cfg: TrainConfig):
    """fn(state, draws, pose (B, 72), shape (B, 10)) -> (loss, task_losses,
    per_frame): the augmented synthetic batch of `draws`, then
    `train_on_batch`.  Over `state.mesh`, the draws, poses and shapes are
    this rank's rows of the global batch.  Raises ValueError on a
    `render.backend` or `smpl_precision` the JAX step raises on."""
    check_jax_only_keys(cfg)

    def step(state: TrainState, draws, pose: torch.Tensor, shape: torch.Tensor) -> StepOutput:
        batch = generate_synthetic_batch(draws, pose, shape, assets, cfg, augment=True)
        return train_on_batch(state, batch, assets, cfg)
    return step


def make_val_step(assets: SmplAssets, cfg: TrainConfig):
    """fn(state, pose, shape) -> (loss, task_losses, per_frame): no
    augmentation, the mean camera and crop, BatchNorm in eval mode, no
    update; over `state.mesh` as `make_train_step`."""
    check_jax_only_keys(cfg)

    @torch.no_grad()
    def step(state: TrainState, pose: torch.Tensor, shape: torch.Tensor) -> StepOutput:
        batch = generate_synthetic_batch(None, pose, shape, assets, cfg, augment=False)
        loss, task_losses, pred_dict, target_dict, pred_reposed = _forward_and_dicts(
            state, batch, assets, cfg, train=False)
        per_frame = _metrics(cfg, pred_dict, target_dict, pred_reposed, batch)
        if state.mesh is not None:
            loss, task_losses = _global_losses(loss, task_losses, state.mesh)
            per_frame = gather_batch(per_frame, state.mesh)
        return loss, task_losses, per_frame
    return step
