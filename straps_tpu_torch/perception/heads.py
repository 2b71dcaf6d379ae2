"""ROI heads: detectron2's box head (2 FCs) and predictor, box inference,
the keypoint head and detectron2's keypoint decode (counterpart of
`straps_tpu/perception/heads.py`), batched over images."""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from straps_tpu_torch.perception import ops

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
POOLER_STRIDES = (4, 8, 16, 32)


class FastRCNNConvFCHead(nn.Module):
    """(R, C, 7, 7) pooled features -> (R, fc_dim): flatten, 2 x (FC, ReLU)."""

    def __init__(self, in_dim: int = 256 * 7 * 7, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc2(F.relu(self.fc1(x.flatten(1)))))


class FastRCNNOutputLayers(nn.Module):
    """Class scores (num_classes + background) and class-specific deltas."""

    def __init__(self, fc_dim: int = 1024, num_classes: int = 1):
        super().__init__()
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


def box_inference(scores: torch.Tensor, deltas: torch.Tensor, proposals: torch.Tensor,
                  proposal_valid: torch.Tensor, img_size: int, score_thresh: float = 0.05,
                  nms_thresh: float = 0.5, max_detections: int = 8):
    """Person-class post-processing per image: softmax, decode with the box
    regression weights, clip, threshold, NMS, the first `max_detections`.

    Args:
      scores: (B, P, C+1); deltas: (B, P, 4C); proposals: (B, P, 4);
      proposal_valid: (B, P).
    Returns:
      (B, D, 4) boxes, (B, D) scores (0 where invalid), (B, D) validity.
    """
    probs = torch.softmax(scores, dim=-1)[..., 0]
    boxes = ops.clip_boxes(ops.decode_boxes(deltas[..., :4], proposals, BOX_REG_WEIGHTS),
                           img_size, img_size)
    s = torch.where(proposal_valid & (probs > score_thresh), probs, -torch.inf)
    keep, keep_valid = ops.nms_fixed(boxes, s, nms_thresh, max_detections)
    safe = keep.clamp(min=0)
    return (torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)),
            torch.gather(probs, 1, safe) * keep_valid, keep_valid)


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """8 x (conv 3x3 512, ReLU), deconv 4x4 stride 2, bilinear 2x:
    (R, C, 14, 14) -> (R, 17, 56, 56) heatmaps."""

    def __init__(self, in_channels: int = 256, conv_dim: int = 512, num_keypoints: int = 17,
                 num_convs: int = 8):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv_fcn{i + 1}",
                            nn.Conv2d(in_channels if i == 0 else conv_dim, conv_dim, 3, 1, 1))
        self.score_lowres = nn.ConvTranspose2d(conv_dim, num_keypoints, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        return F.interpolate(self.score_lowres(x), scale_factor=2, mode="bilinear",
                             align_corners=False)


def keypoint_decode(heatmaps: torch.Tensor, boxes: torch.Tensor, grid_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2's `heatmaps_to_keypoints`: each ROI's heatmaps resized
    with bicubic interpolation (a = -0.75, align_corners=False) to the
    integer ROI size (ceil of the sides, each at least 1 px and at most
    `grid_size`), the first maximum taken, and mapped back through
    x = x1 + (xi + 0.5) * w / ceil(w).  One host synchronisation (the ROI
    sizes), then one `F.interpolate` per ROI, as detectron2 runs it.

    Args:
      heatmaps: (R, K, S, S); boxes: (R, 4) xyxy in the output frame.
    Returns:
      (R, K, 2) xy and (R, K) scores (the resized map at the peak).
    """
    R, K = heatmaps.shape[:2]
    x1, y1 = boxes[:, 0], boxes[:, 1]
    w = (boxes[:, 2] - x1).clamp(min=1.0)
    h = (boxes[:, 3] - y1).clamp(min=1.0)
    wc = torch.ceil(w).clamp(max=grid_size)
    hc = torch.ceil(h).clamp(max=grid_size)
    xi, yi, val = [], [], []
    for r, (hh, ww) in enumerate(torch.stack([hc, wc], 1).to(torch.int64).tolist()):
        m = F.interpolate(heatmaps[r:r + 1], size=(hh, ww), mode="bicubic",
                          align_corners=False)[0].reshape(K, -1)
        pos = m.argmax(dim=1)
        val.append(torch.gather(m, 1, pos[:, None])[:, 0])
        xi.append(pos % ww)
        yi.append(pos // ww)
    if R == 0:
        empty = heatmaps.new_zeros(0, K)
        return torch.stack([empty, empty], dim=-1), empty
    xi, yi, val = torch.stack(xi).float(), torch.stack(yi).float(), torch.stack(val)
    x = x1[:, None] + (xi + 0.5) * (w / wc)[:, None]
    y = y1[:, None] + (yi + 0.5) * (h / hc)[:, None]
    return torch.stack([x, y], dim=-1), val


def pooled_box_features(features_nhwc: List[torch.Tensor], boxes: torch.Tensor,
                        output_size: int, aligned: bool = True, sampling_ratio: int = 0,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """ROIAlign over P2-P5 with FPN level assignment; detectron2's adaptive
    sampling by default (the KP-RCNN and PointRend poolers).
    `compute_dtype=torch.bfloat16` pools in bfloat16 (paired with the
    bfloat16 backbone) and returns float32.

    Args:
      features_nhwc: [(B, H_l, W_l, C)] P2..P5; boxes: (B, R, 4).
    Returns:
      (B * R, C, output_size, output_size) float32, for the heads.
    """
    feats = features_nhwc[:4]
    if compute_dtype is not None:
        feats = [f.to(compute_dtype) for f in feats]
    out = ops.multilevel_roi_align(feats, boxes, POOLER_STRIDES, output_size,
                                   sampling_ratio=sampling_ratio, aligned=aligned)
    B, R, O, _, C = out.shape
    return out.float().reshape(B * R, O, O, C).permute(0, 3, 1, 2)
