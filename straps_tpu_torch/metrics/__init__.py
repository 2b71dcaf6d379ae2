"""Metric math and the trackers (counterpart of `straps_tpu/metrics/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.metrics.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.metrics.compute import ALL_METRICS, compute_per_frame_metrics
from straps_tpu_torch.metrics.eval_tracker import EvalMetricsTracker
from straps_tpu_torch.metrics.tracker import TrainingTracker

__all__ = ["compute_per_frame_metrics", "ALL_METRICS", "TrainingTracker", "EvalMetricsTracker"]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
