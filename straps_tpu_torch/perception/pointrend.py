"""PointRend mask refinement (counterpart of
`straps_tpu/perception/pointrend.py`): the coarse 7x7 mask head, the point
head (1x1 conv1d MLP re-reading the coarse logits at every layer), and the
subdivision loop (5 steps of 2x upsampling + re-predicting the 28² most
uncertain points), with detectron2's module names.  Batched over all ROIs
of a batch of images; `image_index` says which image's P2 a ROI reads.
Training: the importance sampling of the points and the point loss."""

import torch
import torch.nn.functional as F
from torch import nn

from straps_tpu_torch.perception.ops import bilinear_sample
from straps_tpu_torch.perception.rpn import top_k_stable

SUBDIVISION_STEPS = 5
SUBDIVISION_POINTS = 28 * 28


class CoarseMaskHead(nn.Module):
    """(R, 256, 14, 14) -> (R, num_classes, 7, 7) coarse mask logits: conv
    2x2 stride 2, flatten, 2 x (FC 1024, ReLU), the class-specific
    prediction (`PointRend/point_rend/coarse_mask_head.py`, 256-channel
    input, so no channel-reducing conv).  The COCO checkpoint is 80-class;
    person is class 0."""

    def __init__(self, conv_dim: int = 256, fc_dim: int = 1024, num_classes: int = 80,
                 output_side: int = 7):
        super().__init__()
        self.num_classes, self.output_side = num_classes, output_side
        self.reduce_spatial_dim_conv = nn.Conv2d(conv_dim, conv_dim, 2, 2, 0)
        self.coarse_mask_fc1 = nn.Linear(conv_dim * output_side ** 2, fc_dim)
        self.coarse_mask_fc2 = nn.Linear(fc_dim, fc_dim)
        self.prediction = nn.Linear(fc_dim, num_classes * output_side ** 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.reduce_spatial_dim_conv(x)).flatten(1)
        x = F.relu(self.coarse_mask_fc2(F.relu(self.coarse_mask_fc1(x))))
        return self.prediction(x).view(-1, self.num_classes, self.output_side,
                                       self.output_side)


class StandardPointHead(nn.Module):
    """Per point: (fine features ++ coarse logits) -> 3 x (conv1d 256, ReLU,
    ++ coarse logits) -> conv1d predictor (`point_head.py:96-146`)."""

    def __init__(self, fine_dim: int = 256, num_classes: int = 80, fc_dim: int = 256,
                 num_fc: int = 3):
        super().__init__()
        self.num_fc = num_fc
        cin = fine_dim + num_classes
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Conv1d(cin, fc_dim, 1))
            cin = fc_dim + num_classes
        self.predictor = nn.Conv1d(cin, num_classes, 1)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """fine: (R, C, P); coarse: (R, K, P) -> (R, K, P) logits."""
        x = torch.cat([fine, coarse], dim=1)
        for i in range(self.num_fc):
            x = torch.cat([F.relu(getattr(self, f"fc{i + 1}")(x)), coarse], dim=1)
        return self.predictor(x)


def uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-|logit|: the closest to the 0.5 decision boundary, the most uncertain."""
    return -logits.abs()


def sample_mask_at_points(mask: torch.Tensor, points01: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (zero padding) of (R, S, S, K) mask logits at
    (R, P, 2) points in [0, 1] box coordinates -> (R, P, K)."""
    S = mask.shape[1]
    return bilinear_sample(mask, points01[..., 0] * S - 0.5, points01[..., 1] * S - 0.5)


def sample_fine_features(p2: torch.Tensor, boxes: torch.Tensor, points01: torch.Tensor,
                         image_index: torch.Tensor, stride: float = 4.0) -> torch.Tensor:
    """P2 features (B, H, W, C) at box-normalised points (R, P, 2) of boxes
    (R, 4) in image coordinates, each ROI reading its image -> (R, P, C)."""
    x_img = boxes[:, None, 0] + points01[..., 0] * (boxes[:, None, 2] - boxes[:, None, 0])
    y_img = boxes[:, None, 1] + points01[..., 1] * (boxes[:, None, 3] - boxes[:, None, 1])
    return bilinear_sample(p2, x_img / stride - 0.5, y_img / stride - 0.5,
                           batch_index=image_index[:, None])


def subdivision_inference(point_head: StandardPointHead, coarse_logits: torch.Tensor,
                          p2: torch.Tensor, boxes: torch.Tensor, image_index: torch.Tensor,
                          steps: int = SUBDIVISION_STEPS, num_points: int = SUBDIVISION_POINTS,
                          channel: int = 0) -> torch.Tensor:
    """The subdivision loop: upsample the grid 2x, take the `num_points`
    most uncertain cells of `channel` (a stable order: equal uncertainties
    in index order, as `jax.lax.top_k`), re-predict them from P2 features
    and the coarse logits of every class, write them back.  Only `channel`
    is carried in the grid (the point head still reads all classes).

    Args:
      coarse_logits: (R, K, 7, 7); p2: (B, H, W, C); boxes: (R, 4);
        image_index: (R,) int64.
    Returns:
      (R, 1, 7 * 2**steps, 7 * 2**steps) refined logits of `channel`.
    """
    R = coarse_logits.shape[0]
    mask = coarse_logits[:, channel:channel + 1]
    coarse_nhwc = coarse_logits.permute(0, 2, 3, 1)
    S = mask.shape[-1]
    for _ in range(steps):
        S *= 2
        mask = F.interpolate(mask, scale_factor=2, mode="bilinear", align_corners=False)
        _, idx = top_k_stable(uncertainty(mask[:, 0]).reshape(R, S * S), min(num_points, S * S))
        pts01 = torch.stack([((idx % S).float() + 0.5) / S, ((idx // S).float() + 0.5) / S],
                            dim=-1)
        fine = sample_fine_features(p2, boxes, pts01, image_index)          # (R, P, C)
        coarse_pt = sample_mask_at_points(coarse_nhwc, pts01)               # (R, P, K)
        new = point_head(fine.transpose(1, 2), coarse_pt.transpose(1, 2))   # (R, K, P)
        mask = mask.reshape(R, 1, S * S).scatter(
            2, idx[:, None], new[:, channel:channel + 1]).view(R, 1, S, S)
    return mask


def importance_sample_draws(num_rois: int, num_points: int = 14 * 14,
                            oversample_ratio: float = 3.0,
                            importance_sample_ratio: float = 0.75,
                            generator: torch.Generator = None, device=None):
    """The random draws of `importance_sample_points`: (R, int(num_points *
    oversample_ratio), 2) candidates and the (R, num_points -
    int(importance_sample_ratio * num_points), 2) uniform points that fill
    the rest, uniform in [0, 1), from `generator` (on its device)."""
    n_sampled = int(num_points * oversample_ratio)
    n_rand = num_points - int(importance_sample_ratio * num_points)
    device = generator.device if generator is not None else device
    pts = torch.rand((num_rois, n_sampled, 2), generator=generator, device=device)
    rand = torch.rand((num_rois, n_rand, 2), generator=generator, device=device)
    return pts, rand


def select_importance_points(coarse_logits: torch.Tensor, candidates: torch.Tensor,
                             uniform: torch.Tensor, num_uncertain: int) -> torch.Tensor:
    """Given the draws: the candidates most uncertain under the coarse
    logits of class 0 (bilinear, zero padding; a stable order, equal
    uncertainties in index order, as `jax.lax.top_k`), as many as the
    importance share, then the uniform points.

    Args:
      coarse_logits: (R, K, S, S); candidates: (R, N, 2); uniform: (R, M, 2);
        num_uncertain: how many candidates to keep.
    Returns:
      (R, num_uncertain + M, 2) points in [0, 1] box coordinates.
    """
    unc = uncertainty(sample_mask_at_points(coarse_logits[:, :1].permute(0, 2, 3, 1),
                                            candidates)[..., 0])
    _, idx = top_k_stable(unc, num_uncertain)
    chosen = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([chosen, uniform], dim=1)


def importance_sample_points(coarse_logits: torch.Tensor, num_points: int = 14 * 14,
                             oversample_ratio: float = 3.0,
                             importance_sample_ratio: float = 0.75,
                             generator: torch.Generator = None) -> torch.Tensor:
    """Train-time point selection (`PointRend/point_rend/point_features.py:
    63-115` with the default config: 14² points, oversampling 3, importance
    0.75): oversample uniform points, keep the most uncertain share under
    the (R, K, S, S) coarse logits' class 0, fill the rest uniformly.
    Draws from `generator` (on the logits' device when none is given);
    `select_importance_points` is the selection given the draws.
    Returns (R, num_points, 2) points in [0, 1] box coordinates."""
    pts, rand = importance_sample_draws(coarse_logits.shape[0], num_points, oversample_ratio,
                                        importance_sample_ratio, generator,
                                        coarse_logits.device)
    return select_importance_points(coarse_logits, pts, rand,
                                    int(importance_sample_ratio * num_points))


def mask_point_loss(point_logits: torch.Tensor, gt_masks01: torch.Tensor,
                    points01: torch.Tensor) -> torch.Tensor:
    """The point head's loss (`PointRend/point_rend/point_head.py:22-93`):
    binary cross-entropy with logits (max(x, 0) - x z + log1p(exp(-|x|)))
    between (R, P) point logits and the (R, S, S) ground-truth masks
    sampled bilinearly (zero padding) at the same (R, P, 2) points, the
    mean over all points."""
    gt = sample_mask_at_points(gt_masks01[..., None].to(point_logits.dtype), points01)[..., 0]
    return F.binary_cross_entropy_with_logits(point_logits, gt)


def _paste_axis_rows(coord: torch.Tensor, S: int) -> torch.Tensor:
    """(R, N) continuous coordinates -> (R, N, S) bilinear tap rows, taps
    outside [0, S) zero."""
    c0 = torch.floor(coord)
    frac = coord - c0
    c0i = c0.to(torch.int64)
    rows = torch.zeros(coord.shape + (S,), dtype=torch.float32, device=coord.device)
    for ci, wt in ((c0i, 1.0 - frac), (c0i + 1, frac)):
        valid = (ci >= 0) & (ci < S)
        rows.scatter_add_(2, ci.clamp(0, S - 1)[..., None], torch.where(valid, wt, 0.0)[..., None])
    return rows


def paste_mask(mask_logits: torch.Tensor, boxes: torch.Tensor, img_h: int, img_w: int,
               threshold: float = 0.5) -> torch.Tensor:
    """detectron2's `paste_masks_in_image`: the sigmoid of each (S, S) mask
    resampled bilinearly (zero padding) at the pixel centres of its box in
    an (img_h, img_w) frame, then thresholded.  The resampling is
    separable: `Ry @ probs @ Rx^T` per ROI.

    Args:
      mask_logits: (R, S, S); boxes: (R, 4) xyxy in the frame.
    Returns:
      (R, img_h, img_w) bool.
    """
    S = mask_logits.shape[-1]
    dev = mask_logits.device
    ys = torch.arange(img_h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(img_w, dtype=torch.float32, device=dev) + 0.5
    u = (xs - boxes[:, None, 0]) / (boxes[:, None, 2] - boxes[:, None, 0]).clamp(min=1e-6)
    v = (ys - boxes[:, None, 1]) / (boxes[:, None, 3] - boxes[:, None, 1]).clamp(min=1e-6)
    ry = _paste_axis_rows(v * S - 0.5, S)                                   # (R, img_h, S)
    rx = _paste_axis_rows(u * S - 0.5, S)                                   # (R, img_w, S)
    vals = ry @ torch.sigmoid(mask_logits.float()) @ rx.transpose(1, 2)
    inside = ((v >= 0) & (v < 1))[:, :, None] & ((u >= 0) & (u < 1))[:, None, :]
    return (vals * inside) > threshold
