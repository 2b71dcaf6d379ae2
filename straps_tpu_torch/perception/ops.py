"""Detection ops: IoU, exact greedy NMS with a static output size, box
coding, bilinear sampling and ROIAlign (counterpart of
`straps_tpu/perception/ops.py`).

Batched over images: boxes are (B, N, 4), feature maps (B, H, W, C)
(channels last, so that a sample gathers C contiguous values).  ROIAlign
with a fixed sampling ratio is a gather per sample; the adaptive ratio of
detectron2's default pooler (`sampling_ratio=0`, a per-box sample grid) is
evaluated as separable per-box weight rows against the box's own level.
"""

import math
from typing import List, Sequence, Tuple

import torch

# Work of `nms_fixed`: its calls, blocks of candidates, and host
# synchronisations (one per fixpoint round of a block).
NMS_STATS = {"calls": 0, "blocks": 0, "syncs": 0}


def reset_nms_stats() -> None:
    """Zero every count of `NMS_STATS`."""
    for k in NMS_STATS:
        NMS_STATS[k] = 0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...) areas."""
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (ix2 - ix1).clamp(min=0.0) * (iy2 - iy1).clamp(min=0.0)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_outputs: int, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS with a static output size, for a batch of images.

    Candidates are taken in score order (a stable sort: equal scores keep
    the lower index first) in blocks of `block`.  Inside a block the map
    "suppressed by an alive higher scorer" is iterated to its fixpoint,
    which is exactly the greedy kept set; the block's survivors then
    suppress every later candidate at once.  The fixpoint test is the one
    host synchronisation, shared by all images of the batch.

    Args:
      boxes: (B, N, 4) or (N, 4) xyxy; scores: (B, N) or (N,), invalid
        candidates at -inf.
    Returns:
      (B, max_outputs) int64 indices into the input, in score order,
      padded with -1, and the (B, max_outputs) bool validity.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    NMS_STATS["calls"] += 1
    B, N = scores.shape
    dev = boxes.device
    order = torch.sort(-scores, dim=1, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    scores_s = torch.gather(scores, 1, order)
    pad = (-N) % block
    if pad:
        boxes_s = torch.cat([boxes_s, boxes_s.new_zeros(B, pad, 4)], dim=1)
        scores_s = torch.cat([scores_s, scores_s.new_full((B, pad), -math.inf)], dim=1)
    Np = N + pad
    cols = torch.arange(Np, device=dev)
    alive = scores_s > -math.inf
    for start in range(0, Np, block):
        NMS_STATS["blocks"] += 1
        blk = boxes_s[:, start:start + block]
        sup = pairwise_iou(blk, boxes_s) > iou_threshold                # (B, block, Np)
        # Row j of the block (candidate start + j) suppresses later ones only.
        sup &= cols[None, :] > (start + torch.arange(block, device=dev))[:, None]
        a0 = alive[:, start:start + block]
        in_blk = sup[:, :, start:start + block]
        a = a0
        while True:
            a_new = a0 & ~(in_blk & a[:, :, None]).any(dim=1)
            NMS_STATS["syncs"] += 1
            if torch.equal(a_new, a):
                break
            a = a_new
        cross = (sup & a[:, :, None]).any(dim=1)
        cross[:, :start + block] = False
        alive = alive & ~cross
        alive[:, start:start + block] = a
    alive = alive[:, :N]
    rank = torch.cumsum(alive.to(torch.int64), dim=1) - 1
    slot = torch.where(alive & (rank < max_outputs), rank, max_outputs)
    out = torch.full((B, max_outputs + 1), -1, dtype=torch.int64, device=dev)
    out = out.scatter(1, slot, order)[:, :max_outputs]
    if single:
        return out[0], out[0] >= 0
    return out, out >= 0


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Faster-RCNN box coding: target boxes -> (dx, dy, dw, dh) deltas
    relative to anchors (both xyxy)."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + 0.5 * bw
    by = boxes[..., 1] + 0.5 * bh
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), clamp: float = 4.135) -> torch.Tensor:
    """Inverse of `encode_boxes`; dw and dh clamped at detectron2's
    scale_clamp (log(1000/16))."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clamp)
    dh = (deltas[..., 3] / wh).clamp(max=clamp)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, img_w), boxes[..., 1].clamp(0, img_h),
                        boxes[..., 2].clamp(0, img_w), boxes[..., 3].clamp(0, img_h)], dim=-1)


def bilinear_sample(features: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    mode: str = "zeros", batch_index=None) -> torch.Tensor:
    """Bilinear samples of (B, H, W, C) maps at continuous pixel
    coordinates (texel centres at integers).

    `mode="zeros"`: taps outside the map contribute zero (torch
    `grid_sample` with zero padding: PointRend point sampling, mask paste).
    `mode="border"`: torchvision ROIAlign's `bilinear_interpolate`, where a
    sample more than 1 px outside the map is zero and one in the 1 px band
    clamps to the edge texel.

    Args:
      x, y: (B, ...) coordinates, sampling image b of the batch, or any
        shape together with an int64 `batch_index` broadcastable to it.
    Returns:
      (..., C) samples.
    """
    B, H, W, C = features.shape
    if batch_index is None:
        batch_index = torch.arange(B, device=x.device).view((B,) + (1,) * (x.dim() - 1))
    if mode == "border":
        valid = (x >= -1.0) & (x <= W) & (y >= -1.0) & (y <= H)
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = features.reshape(B, H * W, C)

    def tap(xi, yi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[batch_index, idx] * ok[..., None]

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    out = (tap(x0i, y0i) * w00 + tap(x0i + 1, y0i) * w01
           + tap(x0i, y0i + 1) * w10 + tap(x0i + 1, y0i + 1) * w11)
    if mode == "border":
        out = out * valid[..., None]
    return out


def adaptive_axis_rows(start: torch.Tensor, bin_sz: torch.Tensor, grid: torch.Tensor,
                       extent: int, output_size: int, max_grid: int) -> torch.Tensor:
    """Per-box bilinear weight rows along one axis for detectron2's adaptive
    sampling (`POOLER_SAMPLING_RATIO=0`): box r takes `grid[r]` samples per
    output bin at fractions (k + 0.5) / grid[r], each weighted 1 / grid[r]
    (with the other axis, torchvision's `count = max(grid_h * grid_w, 1)`
    average; a box with grid 0 gets zero rows).  torchvision's border
    semantics on an axis of `extent` texels.

    Args:
      start, bin_sz: (R,) float; grid: (R,) float sample counts, at most
        `max_grid`.
    Returns:
      (R, output_size, extent) weight rows.
    """
    R = start.shape[0]
    dev = start.device
    g = grid.clamp(min=1)
    k = torch.arange(max_grid, dtype=torch.float32, device=dev)
    ph = torch.arange(output_size, dtype=torch.float32, device=dev)
    frac_k = (k[None, :] + 0.5) / g[:, None]                               # (R, G)
    coord = start[:, None, None] + bin_sz[:, None, None] * (ph[None, :, None]
                                                            + frac_k[:, None, :])
    in_band = ((coord >= -1.0) & (coord <= extent)).to(coord.dtype)
    coord = coord.clamp(0.0, extent - 1.0)
    c0 = torch.floor(coord)
    frac = coord - c0
    c0i = c0.to(torch.int64)
    w_k = torch.where(k[None, :] < grid[:, None], 1.0 / g[:, None], 0.0)[:, None, :]
    rows = torch.zeros(R, output_size, extent, dtype=torch.float32, device=dev)
    for ci, wt in ((c0i, 1.0 - frac), (c0i + 1, frac)):
        valid = (ci >= 0) & (ci < extent)
        rows.scatter_add_(2, ci.clamp(0, extent - 1), torch.where(valid, wt * in_band * w_k, 0.0))
    return rows


def roi_align(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int, sampling_ratio: int = 2, aligned: bool = True,
              mode: str = "border", max_grid: int = None) -> torch.Tensor:
    """ROIAlign of one feature level.  `aligned=True` is detectron2's
    ROIAlignV2 (half-pixel shift), `aligned=False` the legacy pooler (roi
    sides clamped to >= 1 px).  `mode="zeros"` with `sampling_ratio=1` is
    PointRend's regular-grid point sampling (zero padding).
    `sampling_ratio=0` is the adaptive per-box grid, capped at `max_grid`
    samples per bin and axis (default: the level's own bound).

    Args:
      features: (B, H, W, C); boxes: (B, R, 4) xyxy in image coordinates.
    Returns:
      (B, R, output_size, output_size, C) in the features' dtype.
    """
    B, H, W, C = features.shape
    R = boxes.shape[1]
    O = output_size
    bf = boxes * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = bf.unbind(-1)
    min_wh = (1e-6 if aligned else 1.0) if mode == "border" else 1e-6
    rw = (x2 - x1).clamp(min=min_wh)
    rh = (y2 - y1).clamp(min=min_wh)
    bin_w = rw / O
    bin_h = rh / O
    s = sampling_ratio
    if s == 0:
        if mode != "border":
            raise ValueError("adaptive sampling is a ROIAlign (border) semantics; "
                             "grid_sample paths use sampling_ratio >= 1")
        if max_grid is None:
            max_grid = max(1, -(-max(H, W) // O))
        gw = torch.ceil((rw if not aligned else x2 - x1) / O).clamp(0, max_grid)
        gh = torch.ceil((rh if not aligned else y2 - y1) / O).clamp(0, max_grid)
        out = []
        for b in range(B):
            ry = adaptive_axis_rows(y1[b], bin_h[b], gh[b], H, O, max_grid)
            rx = adaptive_axis_rows(x1[b], bin_w[b], gw[b], W, O, max_grid)
            f = features[b]
            if f.dtype != torch.float32:
                ry, rx = ry.to(f.dtype), rx.to(f.dtype)
            rows = torch.einsum("rph,hwc->rpwc", ry, f)
            out.append(torch.einsum("rqw,rpwc->rpqc", rx, rows).to(f.dtype))
        return torch.stack(out)
    grid = (torch.arange(O * s, dtype=torch.float32, device=boxes.device) + 0.5) / s
    xs = x1[..., None] + bin_w[..., None] * grid                          # (B, R, Q)
    ys = y1[..., None] + bin_h[..., None] * grid
    Q = O * s
    xx = xs[:, :, None, :].expand(B, R, Q, Q)
    yy = ys[:, :, :, None].expand(B, R, Q, Q)
    samples = bilinear_sample(features, xx, yy, mode=mode)
    return samples.reshape(B, R, O, s, O, s, C).mean(dim=(3, 5)).to(features.dtype)


def assign_levels(boxes: torch.Tensor, num_levels: int, min_level: int,
                  canonical_level: int = 4, canonical_size: float = 224.0) -> torch.Tensor:
    """detectron2 `assign_boxes_to_levels`: floor(4 + log2(sqrt(area) /
    224)), clamped to the pyramid; returned as 0-based level indices."""
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(box_area(boxes).clamp(min=1e-9)) / canonical_size + 1e-9))
    return (lvl.clamp(min_level, min_level + num_levels - 1) - min_level).to(torch.int64)


def multilevel_roi_align(features_per_level: List[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], output_size: int,
                         canonical_level: int = 4, canonical_size: float = 224.0,
                         sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """FPN level assignment + ROIAlign: each box is pooled from its own
    level only.  The boxes are grouped by (image, level) with one host
    synchronisation (the group sizes).

    Args:
      features_per_level: [(B, H_l, W_l, C)]; boxes: (B, R, 4).
    Returns:
      (B, R, output_size, output_size, C).
    """
    B, R = boxes.shape[:2]
    L = len(features_per_level)
    C = features_per_level[0].shape[-1]
    O = output_size
    li = assign_levels(boxes, L, int(math.log2(strides[0])), canonical_level, canonical_size)
    key = (torch.arange(B, device=boxes.device)[:, None] * L + li).flatten()
    counts = torch.bincount(key, minlength=B * L).tolist()
    order = torch.argsort(key, stable=True)
    flat_boxes = boxes.reshape(B * R, 4)
    # The adaptive grid's cap is the finest level's bound, as in the JAX
    # package (it binds only for boxes larger than the image).
    max_grid = max(1, -(-max(features_per_level[0].shape[1:3]) // O))
    out = torch.zeros(B * R, O, O, C, dtype=features_per_level[0].dtype,
                      device=boxes.device)
    pos = 0
    for g, n in enumerate(counts):
        if n == 0:
            continue
        b, lvl = divmod(g, L)
        idx = order[pos:pos + n]
        pos += n
        out[idx] = roi_align(features_per_level[lvl][b:b + 1], flat_boxes[idx][None],
                             1.0 / strides[lvl], O, sampling_ratio, aligned,
                             max_grid=max_grid)[0]
    return out.reshape(B, R, O, O, C)
