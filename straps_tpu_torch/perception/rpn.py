"""Region proposal network: detectron2's StandardRPNHead and proposal
selection (counterpart of `straps_tpu/perception/rpn.py`), batched over
images with each image's own top-k and NMS."""

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from straps_tpu_torch.perception import ops


class RPNHead(nn.Module):
    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, features: List[torch.Tensor]):
        """[(B, C, H, W)] -> per level logits (B, A, H, W), deltas (B, 4A, H, W)."""
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


def top_k_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, in descending order, with equal values
    in index order (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    s, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return s[..., :k], idx[..., :k]


def generate_proposals(logits: List[torch.Tensor], deltas: List[torch.Tensor],
                       anchors_per_level: Sequence[np.ndarray], img_size: int,
                       pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                       nms_thresh: float = 0.7):
    """Per image: each level's top `pre_nms_topk` by objectness, decoded and
    clipped; degenerate boxes invalid; NMS per level (one NMS over
    level-offset boxes); the first `post_nms_topk` survivors by score.

    Args:
      logits: per level (B, A, H, W); deltas: per level (B, 4A, H, W).
    Returns:
      (B, post_nms_topk, 4) boxes, (B, post_nms_topk) scores and validity.
    """
    cand_boxes, cand_scores, cand_levels = [], [], []
    for lvl, (lg, dl, anch) in enumerate(zip(logits, deltas, anchors_per_level)):
        B, A, H, W = lg.shape
        scores = lg.permute(0, 2, 3, 1).reshape(B, -1)                      # (h, w, a) order
        d = dl.view(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
        if scores.shape[1] != anch.shape[0]:
            raise ValueError(f"level {lvl}: {scores.shape[1]} RPN predictions vs "
                             f"{anch.shape[0]} anchors: the anchor grid does not match "
                             f"the feature map (pass feat_sizes to fpn_anchors)")
        k = min(pre_nms_topk, scores.shape[1])
        top_scores, top_idx = top_k_stable(scores, k)
        anchors = torch.as_tensor(anch, device=lg.device)[top_idx]
        boxes = ops.decode_boxes(torch.gather(d, 1, top_idx[..., None].expand(B, k, 4)), anchors)
        cand_boxes.append(ops.clip_boxes(boxes, img_size, img_size))
        cand_scores.append(top_scores)
        cand_levels.append(torch.full((B, k), float(lvl), device=lg.device))
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    levels = torch.cat(cand_levels, dim=1)
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    scores = torch.where(valid, scores, -torch.inf)
    offset = levels[..., None] * (2.0 * img_size + 2.0)
    keep, keep_valid = ops.nms_fixed(boxes + offset, scores, nms_thresh, post_nms_topk)
    safe = keep.clamp(min=0)
    return (torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)),
            torch.gather(scores, 1, safe), keep_valid)
