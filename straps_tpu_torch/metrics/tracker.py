"""Training loss/metric tracker with pickled history + best-model gating
(a copy of `straps_tpu/metrics/tracker.py`, numpy only).

The reference's history-dict key naming (`train_pves_pa`, `val_losses`,
...), per-epoch normalisation, pickle log format, resume-truncation
semantics and the all-metrics-must-improve save gate.  The per-batch metric
math runs on the device (`straps_tpu_torch.metrics.compute`).  A tracked
task beyond the reference's five (the optional 'silhouette') gets its own
`train_/val_<task>_losses` series after theirs: the JAX package's tracker
has no series for it and raises a KeyError on its first batch.
"""

import pickle
from typing import Dict, List

import numpy as np

ALL_PER_TASK_LOSSES = ("verts", "shape_params", "pose_params", "joints2D",
                       "joints3D")
ALL_METRIC_TYPES = ("pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc",
                    "pve-ts_pa", "mpjpes", "mpjpes_sc", "mpjpes_pa",
                    "pose_mses", "shape_mses", "joints2D_l2es")


class TrainingTracker:
    def __init__(self, losses_to_track, metrics_to_track, log_path: str,
                 load_logs: bool = False, current_epoch: int = 0):
        self.losses_to_track = list(losses_to_track)
        self.metrics_to_track = list(metrics_to_track)
        self.tasks = ALL_PER_TASK_LOSSES + tuple(t for t in self.losses_to_track
                                                 if t not in ALL_PER_TASK_LOSSES)
        self.log_path = log_path
        if load_logs:
            self.history = self._load_history(log_path, current_epoch)
        else:
            self.history = {"train_losses": [], "val_losses": []}
            for t in self.tasks:
                self.history[f"train_{t}_losses"] = []
                self.history[f"val_{t}_losses"] = []
            for m in ALL_METRIC_TYPES:
                self.history[f"train_{m}"] = []
                self.history[f"val_{m}"] = []
        self._sums: Dict[str, float] = {}
        self.initialise_loss_metric_sums()

    def _load_history(self, path: str, current_epoch: int) -> Dict[str, List[float]]:
        """Resume: truncate every series to `current_epoch`, zero-fill missing
        series (`train_loss_and_metrics_tracker.py:52-90`)."""
        with open(path, "rb") as f:
            history = pickle.load(f)
        keys = (["train_losses", "val_losses"]
                + [f"{s}_{t}_losses" for t in self.tasks
                   for s in ("train", "val")]
                + [f"{s}_{m}" for m in ALL_METRIC_TYPES for s in ("train", "val")])
        for k in keys:
            if k in history:
                history[k] = history[k][:current_epoch]
            else:
                history[k] = [0.0] * current_epoch
        return {k: history[k] for k in keys}

    def initialise_loss_metric_sums(self):
        self._sums = {"train_losses": 0.0, "val_losses": 0.0,
                      "train_num_samples": 0, "val_num_samples": 0}
        for t in self.tasks:
            self._sums[f"train_{t}_losses"] = 0.0
            self._sums[f"val_{t}_losses"] = 0.0
        for m in ALL_METRIC_TYPES:
            self._sums[f"train_{m}"] = 0.0
            self._sums[f"val_{m}"] = 0.0

    def update_per_batch(self, split: str, loss: float,
                         task_losses: Dict[str, float],
                         per_frame_metrics: Dict[str, np.ndarray],
                         num_inputs: int):
        """Accumulate one batch.  `per_frame_metrics` comes from
        `compute_per_frame_metrics` (values already per-frame means)."""
        assert split in ("train", "val")
        self._sums[f"{split}_losses"] += float(loss) * num_inputs
        self._sums[f"{split}_num_samples"] += num_inputs
        for t in self.losses_to_track:
            self._sums[f"{split}_{t}_losses"] += float(task_losses[t]) * num_inputs
        for m in self.metrics_to_track:
            self._sums[f"{split}_{m}"] += float(np.sum(np.asarray(
                per_frame_metrics[m])))

    def update_per_epoch(self):
        for split in ("train", "val"):
            n = max(self._sums[f"{split}_num_samples"], 1)
            self.history[f"{split}_losses"].append(
                self._sums[f"{split}_losses"] / n)
            for t in self.tasks:
                val = (self._sums[f"{split}_{t}_losses"] / n
                       if t in self.losses_to_track else 0.0)
                self.history[f"{split}_{t}_losses"].append(val)
            for m in ALL_METRIC_TYPES:
                val = (self._sums[f"{split}_{m}"] / n
                       if m in self.metrics_to_track else 0.0)
                self.history[f"{split}_{m}"].append(val)
        with open(self.log_path, "wb") as f:
            pickle.dump(self.history, f)

    def determine_save_model_weights_this_epoch(self, save_val_metrics,
                                                best_epoch_val_metrics) -> bool:
        """True only if *every* gating metric improved
        (`train_loss_and_metrics_tracker.py:267-274`)."""
        for metric in save_val_metrics:
            if self.history[f"val_{metric}"][-1] > best_epoch_val_metrics[metric]:
                return False
        return True
