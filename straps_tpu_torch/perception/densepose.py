"""DensePose heads of the detector front end and their training side
(counterpart of `straps_tpu/perception/densepose.py`), with detectron2's
module names.

`DensePoseV1ConvXHead` (8 x conv3x3, 512 channels, ReLU) over 14x14 ROI
features, then `DensePosePredictor`'s four deconvolution branches (coarse
segmentation S, 15 channels; patch index I, U and V, 25 channels each),
each 4x4 stride 2 and then a 2x bilinear upsampling, to 56x56
(`DensePose/densepose/densepose_head.py:271-345`).  STRAPS consumes the
part labels as a binary silhouette.

The DeepLab head (`DensePoseDeepLabHead`: ASPP, the optional NonLocal
block, 8 stacked GroupNorm convs; `densepose_head.py:24-268`) loads the
model zoo's `*_DL_*` checkpoints by name.  Training: `densepose_data_filter`,
`densepose_losses` (`densepose_head.py:348-385`, `:752-873`).  The result
wire format: `densepose_result_uint8` per detection, `iuv_to_uint8_image`,
and the base64 PNG codec (`encode_iuv_png`, `decode_iuv_png`).

The frame paste is detectron2's (`DensePose/densepose/structures.py:
374-401` with `predict/predict_densepose.py:95-101`): per detection the S
and I logits resized bilinearly to the integer box size, the argmax taken
after the resize, the labels pasted at the truncated box origin.  The JAX
package evaluates the same function as separable weight matrices over a
static frame grid, a workaround for dynamic sizes on the TPU.
"""

import base64
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from straps_tpu_torch.perception.fpn import Conv2dNorm
from straps_tpu_torch.perception.ops import bilinear_sample, pairwise_iou
from straps_tpu_torch.utils.png import decode_png_bytes, encode_png

NUM_PATCHES = 24
NUM_COARSE_SEG = 15
PREDICTOR_BRANCHES = (("ann_index_lowres", NUM_COARSE_SEG),
                      ("index_uv_lowres", NUM_PATCHES + 1),
                      ("u_lowres", NUM_PATCHES + 1),
                      ("v_lowres", NUM_PATCHES + 1))


class DensePoseV1ConvXHead(nn.Module):
    """(R, C, 14, 14) ROI features -> (R, 512, 14, 14): 8 x (conv 3x3, ReLU)."""

    def __init__(self, in_channels: int = 256, conv_dim: int = 512, num_convs: int = 8):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"body_conv_fcn{i + 1}",
                            nn.Conv2d(in_channels if i == 0 else conv_dim, conv_dim, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"body_conv_fcn{i + 1}")(x))
        return x


class DensePosePredictor(nn.Module):
    """(R, 512, 14, 14) -> S (R, 15, 56, 56), I, U, V (R, 25, 56, 56): per
    branch a 4x4 stride-2 deconvolution, then a 2x bilinear upsampling
    (`align_corners=False`)."""

    def __init__(self, in_channels: int = 512):
        super().__init__()
        for name, channels in PREDICTOR_BRANCHES:
            self.add_module(name, nn.ConvTranspose2d(in_channels, channels, 4, 2, 1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(F.interpolate(getattr(self, name)(x), scale_factor=2, mode="bilinear",
                                   align_corners=False)
                     for name, _ in PREDICTOR_BRANCHES)


def group_norm(channels: int) -> nn.GroupNorm:
    """detectron2's GroupNorm of the DeepLab head: 32 groups, eps 1e-5."""
    return nn.GroupNorm(32, channels, eps=1e-5)


class ASPPPooling(nn.Sequential):
    """The image-level branch of ASPP: a global average pool, a bias-free
    1x1 conv, GroupNorm, ReLU, resized back to the input's size as the
    reference resizes it (bilinear from 1x1: a broadcast up to rounding)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), nn.Conv2d(in_channels, out_channels, 1,
                                                            bias=False),
                         group_norm(out_channels), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(super().forward(x), size=x.shape[-2:], mode="bilinear",
                             align_corners=False)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (`densepose_head.py:89-145`):
    `convs.0` a 1x1 branch, `convs.1-3` 3x3 branches at dilations `rates`,
    `convs.4` the pooling branch, each bias-free with GroupNorm(32) and
    ReLU; `project.0` a bias-free 1x1 over their concatenation, then ReLU
    (no norm: the reference comments its BatchNorm out)."""

    def __init__(self, in_channels: int, out_channels: int, rates=(6, 12, 56)):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, bias=False),
                           group_norm(out_channels), nn.ReLU())]
            + [nn.Sequential(nn.Conv2d(in_channels, out_channels, 3, padding=r, dilation=r,
                                       bias=False), group_norm(out_channels), nn.ReLU())
               for r in rates]
            + [ASPPPooling(in_channels, out_channels)])
        self.project = nn.Sequential(nn.Conv2d(5 * out_channels, out_channels, 1, bias=False),
                                     nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class NonLocalBlock2D(nn.Module):
    """Embedded-Gaussian self-attention over the ROI's positions
    (`densepose_head.py:150-268`, sub-sampled, with its GroupNorm):
    theta, phi and g 1x1 projections to half the width, phi and g max-pooled
    2x2, softmax(theta phi^T) g, then `W` (a 1x1 conv and a GroupNorm whose
    weight and bias start at 0, so the block starts as the identity) added
    to the input."""

    def __init__(self, in_channels: int, inter_channels: int = None):
        super().__init__()
        self.inter_channels = inter_channels or in_channels // 2
        c = self.inter_channels
        self.g = nn.Sequential(nn.Conv2d(in_channels, c, 1), nn.MaxPool2d(2))
        self.theta = nn.Conv2d(in_channels, c, 1)
        self.phi = nn.Sequential(nn.Conv2d(in_channels, c, 1), nn.MaxPool2d(2))
        self.W = nn.Sequential(nn.Conv2d(c, in_channels, 1), group_norm(in_channels))
        nn.init.zeros_(self.W[1].weight)
        nn.init.zeros_(self.W[1].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        R, _, H, W = x.shape
        c = self.inter_channels
        q = self.theta(x).reshape(R, c, H * W).transpose(1, 2)          # (R, HW, c)
        k = self.phi(x).reshape(R, c, -1)                                # (R, c, HW/4)
        v = self.g(x).reshape(R, c, -1).transpose(1, 2)                 # (R, HW/4, c)
        y = torch.bmm(torch.softmax(torch.bmm(q, k), dim=-1), v)
        return x + self.W(y.transpose(1, 2).reshape(R, c, H, W))


class DensePoseDeepLabHead(nn.Module):
    """(R, C, 14, 14) ROI features -> (R, conv_dim, 14, 14): ASPP at the
    input width, the NonLocal block (`use_nonlocal`, the reference's
    DEEPLAB.NONLOCAL_ON), then `num_convs` x (bias-free 3x3 conv, GroupNorm,
    ReLU) as detectron2's `Conv2d(norm=GN)` named `body_conv_fcn{i}` with
    its `.norm` (`densepose_head.py:24-61`)."""

    def __init__(self, in_channels: int = 256, conv_dim: int = 512, num_convs: int = 8,
                 use_nonlocal: bool = False):
        super().__init__()
        self.num_convs = num_convs
        self.ASPP = ASPP(in_channels, in_channels)
        if use_nonlocal:
            self.NLBlock = NonLocalBlock2D(in_channels, in_channels // 2)
        for i in range(num_convs):
            self.add_module(f"body_conv_fcn{i + 1}",
                            Conv2dNorm(in_channels if i == 0 else conv_dim, conv_dim, 3, 1, 1,
                                       bias=False, norm=group_norm(conv_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ASPP(x)
        if hasattr(self, "NLBlock"):
            x = self.NLBlock(x)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"body_conv_fcn{i + 1}")(x))
        return x


def densepose_to_iuv(s: torch.Tensor, i: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ROI logits (R, C, S, S) -> the part index map (R, S, S), 0 where
    the coarse segmentation's argmax is background, and U and V of that
    part (`densepose_head.py:403-437`)."""
    part = torch.where(s.argmax(dim=1) > 0, i.argmax(dim=1), 0)
    return (part, torch.gather(u, 1, part[:, None])[:, 0],
            torch.gather(v, 1, part[:, None])[:, 0])


def paste_part_labels(s_logits: torch.Tensor, i_logits: torch.Tensor, boxes: torch.Tensor,
                      out_h: int, out_w: int) -> torch.Tensor:
    """detectron2's DensePose labels of each box in an (out_h, out_w) frame.

    Box r's S and I logits are resized bilinearly (`align_corners=False`)
    to its integer size, w = max(int(x2 - x1), 1) and likewise h; its
    labels are the I argmax where the S argmax is foreground, 0 elsewhere,
    pasted at (int(y1), int(x1)) and cut at the frame's edge.  Boxes are
    frame-clipped, so their corners are non-negative.  One host
    synchronisation for the sizes, then one `F.interpolate` per box.

    Args:
      s_logits: (R, C_s, S, S); i_logits: (R, C_i, S, S); boxes: (R, 4)
        xyxy in the frame.
    Returns:
      (R, out_h, out_w) uint8 labels, 0 = background.
    """
    R, ns = s_logits.shape[:2]
    out = torch.zeros(R, out_h, out_w, dtype=torch.uint8, device=boxes.device)
    if R == 0:
        return out
    w = torch.trunc(boxes[:, 2] - boxes[:, 0]).clamp(min=1)
    h = torch.trunc(boxes[:, 3] - boxes[:, 1]).clamp(min=1)
    geometry = torch.stack([torch.trunc(boxes[:, 0]), torch.trunc(boxes[:, 1]), w, h], 1)
    si = torch.cat([s_logits, i_logits], dim=1)
    for r, (x0, y0, ww, hh) in enumerate(geometry.to(torch.int64).tolist()):
        scores = F.interpolate(si[r:r + 1], size=(hh, ww), mode="bilinear",
                               align_corners=False)[0]
        labels = torch.where(scores[:ns].argmax(dim=0) > 0, scores[ns:].argmax(dim=0), 0)
        ch, cw = max(min(hh, out_h - y0), 0), max(min(ww, out_w - x0), 0)
        out[r, y0:y0 + ch, x0:x0 + cw] = labels[:ch, :cw].to(torch.uint8)
    return out


def densepose_data_filter(proposal_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                          has_densepose: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float = 0.7) -> torch.Tensor:
    """detectron2's `DensePoseDataFilter` (`densepose_head.py:348-385`) as
    a mask: proposal r is kept when its IoU with its matched ground-truth
    box r exceeds FG_IOU_THRESHOLD (0.7) and that box carries a DensePose
    annotation.  (R, 4) xyxy boxes and (R,) bools -> (R,) bool."""
    iou = pairwise_iou(proposal_boxes[:, None], gt_boxes[:, None])[:, 0, 0]
    return (iou > iou_threshold) & has_densepose.bool() & valid.bool()


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def iuv_to_uint8_image(part, u, v) -> np.ndarray:
    """(S, S) part index, U and V maps -> the (S, S, 3) uint8 IUV image of
    a detectron2 DensePose result: the part index, then U and V times 255,
    clipped to [0, 255] and truncated."""
    return np.stack([
        _to_numpy(part).astype(np.uint8),
        np.clip(_to_numpy(u) * 255.0, 0, 255).astype(np.uint8),
        np.clip(_to_numpy(v) * 255.0, 0, 255).astype(np.uint8),
    ], axis=-1)


def densepose_losses(s: torch.Tensor, i: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     gt_segm: torch.Tensor, gt_points01: torch.Tensor, gt_part: torch.Tensor,
                     gt_u: torch.Tensor, gt_v: torch.Tensor, point_valid: torch.Tensor,
                     w_points: float = 0.1, w_part: float = 0.3,
                     w_segm: float = 2.0) -> Dict[str, torch.Tensor]:
    """DensePose training losses (`densepose_head.py:752-873`): the coarse
    segmentation's cross-entropy over the whole grid; at the annotated
    points, the patch index's cross-entropy and the smooth-L1 (beta 1) of U
    and V of the ground-truth patch, on bilinear samples (zero padding, the
    point p of the box at p * S - 0.5) and over the valid points, whose
    count is floored at 1; weights from `DensePose/densepose/config.py:
    32-36`.  `total` = w_segm * segm + w_part * part + w_points * (u + v).

    Args:
      s: (R, 15, S, S); i, u, v: (R, 25, S, S) logits, as the predictor
        gives them.
      gt_segm: (R, S, S) int coarse labels.
      gt_points01: (R, P, 2) points in box space [0, 1]; gt_part: (R, P)
        int patch index 0..24 (read only at valid points); gt_u, gt_v:
        (R, P); point_valid: (R, P) bool.
    """
    loss_segm = F.cross_entropy(s, gt_segm.long())
    S = i.shape[-1]
    px, py = gt_points01[..., 0] * S - 0.5, gt_points01[..., 1] * S - 0.5
    i_pts = bilinear_sample(i.permute(0, 2, 3, 1), px, py)                 # (R, P, 25)
    pv = point_valid.to(i.dtype)
    denom = pv.sum().clamp(min=1.0)
    part = torch.where(point_valid.bool(), gt_part.long(), 0)
    loss_part = (F.cross_entropy(i_pts.flatten(0, 1), part.flatten(), reduction="none")
                 * pv.flatten()).sum() / denom
    uv = bilinear_sample(torch.cat([u, v], 1).permute(0, 2, 3, 1), px, py)  # (R, P, 50)
    n = u.shape[1]
    u_sel = torch.gather(uv[..., :n], -1, part[..., None])[..., 0]
    v_sel = torch.gather(uv[..., n:], -1, part[..., None])[..., 0]
    loss_u = (F.smooth_l1_loss(u_sel, gt_u, reduction="none", beta=1.0) * pv).sum() / denom
    loss_v = (F.smooth_l1_loss(v_sel, gt_v, reduction="none", beta=1.0) * pv).sum() / denom
    total = w_segm * loss_segm + w_part * loss_part + w_points * (loss_u + loss_v)
    return {"total": total, "segm": loss_segm, "part": loss_part, "u": loss_u, "v": loss_v}


def densepose_result_uint8(s: torch.Tensor, i: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                           box_xyxy) -> np.ndarray:
    """One detection's detectron2 DensePose result (`DensePose/densepose/
    structures.py:374-401`): its (C, S, S) S, I, U and V logits resized
    bilinearly (`align_corners=False`, as `paste_part_labels`) to the
    integer box size max(int(w), 1) x max(int(h), 1), the part index the
    I argmax after the resize where the S argmax is foreground, U and V of
    that part times 255, clipped and truncated -> the (h, w, 3) uint8 IUV
    image that `encode_iuv_png` packs."""
    x1, y1, x2, y2 = (float(c) for c in _to_numpy(box_xyxy))
    w, h = max(int(x2 - x1), 1), max(int(y2 - y1), 1)
    ns, ni = s.shape[0], i.shape[0]
    scores = F.interpolate(torch.cat([s, i, u, v]).float()[None], size=(h, w),
                           mode="bilinear", align_corners=False)[0]
    part = torch.where(scores[:ns].argmax(0) > 0, scores[ns:ns + ni].argmax(0), 0)
    uv = scores[ns + ni:].view(2, -1, h, w)
    sel = torch.gather(uv, 1, part[None, None].expand(2, 1, h, w))[:, 0]
    uv8 = torch.where(part > 0, (sel * 255.0).clamp(0, 255).to(torch.uint8), 0)
    return torch.cat([part[None].to(torch.uint8), uv8]).permute(1, 2, 0).cpu().numpy()


def encode_iuv_png(iuv_uint8) -> str:
    """An (H, W, 3) uint8 IUV image -> base64 PNG, the wire format of
    DensePose results (`DensePose/densepose/structures.py:355-455`)."""
    return base64.b64encode(encode_png(np.asarray(iuv_uint8, np.uint8))).decode("ascii")


def decode_iuv_png(data: str) -> np.ndarray:
    """The inverse of `encode_iuv_png`: (H, W, 3) uint8."""
    return decode_png_bytes(base64.b64decode(data), "<IUV PNG>")
