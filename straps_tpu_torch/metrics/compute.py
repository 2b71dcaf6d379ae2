"""Per-frame metric math (counterpart of `straps_tpu/metrics/compute.py`).

Alignment variants: `_sc` = scale + translation correction, `_pa` =
Procrustes.  Trackers aggregate the per-frame values on the host.
"""

from typing import Dict, Optional, Tuple

import torch

from straps_tpu_torch.geometry.alignment import (
    compute_similarity_transform, scale_and_translation_transform,
)
from straps_tpu_torch.geometry.joints import undo_keypoint_normalisation

ALL_METRICS = ("pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc", "pve-ts_pa",
               "mpjpes", "mpjpes_sc", "mpjpes_pa", "pose_mses", "shape_mses",
               "joints2D_l2es", "silhouette_ious")

# Metrics whose Procrustes solve checks on the host that it converged
# (`torch.linalg.svd` on CUDA waits for the device), so that no CUDA graph
# can capture them.
HOST_CHECKED_METRICS = ("pves_pa", "pve-ts_pa", "mpjpes_pa")

_ALIGN = {"": lambda p, t: p,
          "_sc": scale_and_translation_transform,
          "_pa": compute_similarity_transform}


def _mean_norm(a, b):
    """Per-frame mean Euclidean error: (B, N, D) -> (B,)."""
    return torch.linalg.vector_norm(a - b, dim=-1).mean(dim=-1)


def compute_per_frame_metrics(metrics: Tuple[str, ...],
                              pred: Dict[str, torch.Tensor],
                              target: Dict[str, torch.Tensor],
                              img_wh: int,
                              pred_reposed: Optional[torch.Tensor] = None,
                              target_reposed: Optional[torch.Tensor] = None,
                              joints2d_pred_normalised: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """{metric: (B,) per-frame values}.

    pred/target hold verts (B, V, 3), joints3D (B, 14, 3), joints2D (B, J, 2),
    pose_params_rot_matrices (B, 24, 3, 3), shape_params (B, 10) and
    silhouettes (B, H, W) as the metrics need them; pred_reposed and
    target_reposed (B, V, 3) feed the pve-ts family.  'silhouette_ious'
    also returns the per-frame 'silhouette_tp/fp/fn/tn' counts.
    """
    out = {}
    pairs = {"pves": (pred.get("verts"), target.get("verts")),
             "pve-ts": (pred_reposed, target_reposed),
             "mpjpes": (pred.get("joints3D"), target.get("joints3D"))}
    for base, (p, t) in pairs.items():
        for suffix, align in _ALIGN.items():
            if base + suffix in metrics:
                out[base + suffix] = _mean_norm(align(p, t), t)
    if "pose_mses" in metrics:
        d = pred["pose_params_rot_matrices"] - target["pose_params_rot_matrices"]
        out["pose_mses"] = (d ** 2).mean(dim=(1, 2, 3))
    if "shape_mses" in metrics:
        d = pred["shape_params"] - target["shape_params"]
        out["shape_mses"] = (d ** 2).mean(dim=-1)
    if "joints2D_l2es" in metrics:
        p = pred["joints2D"]
        if joints2d_pred_normalised:
            p = undo_keypoint_normalisation(p, img_wh)
        out["joints2D_l2es"] = _mean_norm(p, target["joints2D"])
    if "silhouette_ious" in metrics:
        ps = pred["silhouettes"] != 0
        ts = target["silhouettes"] != 0
        tp = (ps & ts).sum(dim=(1, 2)).to(torch.float32)
        fp = (ps & ~ts).sum(dim=(1, 2)).to(torch.float32)
        fn = (~ps & ts).sum(dim=(1, 2)).to(torch.float32)
        tn = (~ps & ~ts).sum(dim=(1, 2)).to(torch.float32)
        out["silhouette_ious"] = tp / torch.clamp(tp + fp + fn, min=1.0)
        out["silhouette_tp"] = tp
        out["silhouette_fp"] = fp
        out["silhouette_fn"] = fn
        out["silhouette_tn"] = tn
    return out
