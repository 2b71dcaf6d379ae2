"""Anchor generation for FPN levels: detectron2's DefaultAnchorGenerator
(one size per level, 3 aspect ratios, offset 0), in numpy (a copy of
`straps_tpu/perception/anchors.py`)."""

from typing import List, Sequence

import numpy as np


def cell_anchors(size: float, aspect_ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) xyxy anchors centred at (0, 0) with the given area and ratios."""
    out = []
    area = size * size
    for ar in aspect_ratios:
        w = np.sqrt(area / ar)
        h = ar * w
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, size: float,
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """(feat_h * feat_w * A, 4) anchors of one level, row-major over the
    grid, then anchor index (detectron2's order)."""
    base = cell_anchors(size, aspect_ratios)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)


def fpn_anchors(image_size: int, strides: Sequence[int] = (4, 8, 16, 32, 64),
                sizes: Sequence[float] = (32, 64, 128, 256, 512),
                aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                feat_sizes: Sequence = None) -> List[np.ndarray]:
    """Per-level anchors of a square image.  `feat_sizes` ((h, w) per
    level) sizes the grids from the real feature maps, as detectron2 does:
    at 800² P6 is 13x13 (a stride-2 pool of the 25x25 P5), not 800 // 64 =
    12.  Without it the grids are `image_size // stride`."""
    out = []
    for i, (stride, size) in enumerate(zip(strides, sizes)):
        if feat_sizes is not None:
            fh, fw = int(feat_sizes[i][0]), int(feat_sizes[i][1])
        else:
            fh = fw = image_size // stride
        out.append(grid_anchors(fh, fw, stride, size, aspect_ratios))
    return out
