"""Homoscedastic-uncertainty-weighted multi-task loss (counterpart of
`straps_tpu/losses/multi_task.py`).

Per-task MSE losses weighted by learned log-variances (Kendall et al.):
`total += mse * exp(-logvar) + logvar`.  The log-variances are leaf tensors
that the caller optimises together with the network parameters.  joints2D
labels are normalised to [-1, 1] and masked by per-joint visibility.

Over a data mesh each rank computes its share of the global batch's loss:
every task's squared errors over the global count (joints2D's over the
global visible count), and each log-variance term on rank 0 alone, so that
the shares, and their gradients, sum over the ranks to the global loss's.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from straps_tpu_torch.geometry.joints import normalise_keypoints
from straps_tpu_torch.parallel.mesh import all_reduce_

ALL_TASKS = ("verts", "joints2D", "joints3D", "pose_params", "shape_params",
             "silhouette")


def init_loss_log_vars(losses_on, init_loss_weights: Optional[dict] = None,
                       eps: float = 1e-6, device="cpu") -> Dict[str, torch.Tensor]:
    """Initial log-variances, -log(w + eps), or 0 without init weights, as
    float32 leaf tensors that require gradients; one per active task."""
    out = {}
    for task in losses_on:
        value = (-np.log(init_loss_weights[task] + eps)
                 if init_loss_weights is not None else 0.0)
        out[task] = torch.tensor(np.float32(value), device=device, requires_grad=True)
    return out


def multi_task_loss(log_vars: Dict[str, torch.Tensor],
                    labels: Dict[str, torch.Tensor],
                    outputs: Dict[str, torch.Tensor],
                    img_wh: int, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and the per-task weighted losses; with `mesh`
    (a `parallel.DataMesh`, each rank passing its rows) this rank's shares
    of them.

    Args:
      log_vars: {task: scalar} learned log-variances (the active tasks).
      labels/outputs: verts (B, V, 3), joints2D (B, J, 2), joints3D
        (B, 14, 3), pose_params_rot_matrices (B, 24, 3, 3), shape_params
        (B, 10), silhouettes (B, S, S) for the 'silhouette' task; labels
        may carry 'vis' (B, J) bool.
      img_wh: image size of the joints2D labels (pixels).
    Returns:
      (total scalar, {task: mse * exp(-logvar)}).
    """
    device = next(iter(log_vars.values())).device
    total = torch.zeros((), dtype=torch.float32, device=device)
    loss_dict = {}

    def add(task, mse):
        nonlocal total
        lv = log_vars[task]
        weighted = mse * torch.exp(-lv)
        total = total + (weighted + lv if mesh is None or mesh.rank == 0 else weighted)
        loss_dict[task] = weighted

    def _mse(pred, target):
        if mesh is None:
            return torch.mean((pred - target) ** 2)
        return torch.sum((pred - target) ** 2) / (pred.numel() * mesh.size)

    if "verts" in log_vars:
        add("verts", _mse(outputs["verts"], labels["verts"]))

    if "joints2D" in log_vars:
        label = normalise_keypoints(labels["joints2D"], img_wh)
        pred = outputs["joints2D"]
        if "vis" in labels:
            vis = labels["vis"].to(pred.dtype)[..., None]          # (B, J, 1)
            visible = vis.sum()
            if mesh is not None:
                all_reduce_([visible], mesh)
            count = torch.clamp(visible * 2.0, min=1.0)
            mse = torch.sum(((pred - label) ** 2) * vis) / count
        else:
            mse = _mse(pred, label)
        add("joints2D", mse)

    if "joints3D" in log_vars:
        add("joints3D", _mse(outputs["joints3D"], labels["joints3D"]))

    if "shape_params" in log_vars:
        add("shape_params", _mse(outputs["shape_params"], labels["shape_params"]))

    if "pose_params" in log_vars:
        add("pose_params", _mse(outputs["pose_params_rot_matrices"],
                                labels["pose_params_rot_matrices"]))

    if "silhouette" in log_vars:
        add("silhouette", _mse(outputs["silhouettes"], labels["silhouettes"]))

    return total, loss_dict
