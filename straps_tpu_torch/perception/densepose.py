"""DensePose head of the detector front end (counterpart of
`straps_tpu/perception/densepose.py`), with detectron2's module names.

`DensePoseV1ConvXHead` (8 x conv3x3, 512 channels, ReLU) over 14x14 ROI
features, then `DensePosePredictor`'s four deconvolution branches (coarse
segmentation S, 15 channels; patch index I, U and V, 25 channels each),
each 4x4 stride 2 and then a 2x bilinear upsampling, to 56x56
(`DensePose/densepose/densepose_head.py:271-345`).  STRAPS consumes the
part labels as a binary silhouette.

The frame paste is detectron2's (`DensePose/densepose/structures.py:
374-401` with `predict/predict_densepose.py:95-101`): per detection the S
and I logits resized bilinearly to the integer box size, the argmax taken
after the resize, the labels pasted at the truncated box origin.  The JAX
package evaluates the same function as separable weight matrices over a
static frame grid, a workaround for dynamic sizes on the TPU.

Not ported (on no path of the JAX package's configs): the DeepLab head
(`DensePoseDeepLabHead`, `ASPP`, `NonLocalBlock2D`), the training
functions and the IUV wire format.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
