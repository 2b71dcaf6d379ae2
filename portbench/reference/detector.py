"""The plain float32 reference of the photo path's two detectors, and of
the image handling before them: detectron2's Keypoint R-CNN R50-FPN
(`COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml`) and PointRend R50-FPN
(`projects/PointRend/configs/InstanceSegmentation/
pointrend_rcnn_R_50_FPN_3x_coco.yaml`) at inference, as STRAPS's
`predict_3D.py` runs them on a photo padded to a square and resized to 512.

Written from detectron2's and torchvision's definitions, one image at a
time, in float32 (TF32 off), with each step the plain way: greedy NMS as the
textbook loop, ROIAlign as bilinear samples averaged per bin, PointRend's
points through `grid_sample`.  It imports nothing of the port.

- Images: cv2's `INTER_LINEAR` resize of uint8 pixels (11-bit weights, the
  SIMD vertical pass's shifts, the 2x2 mean of an exact halving) and
  Pillow's bilinear `resize` (22-bit weights, a horizontal then a vertical
  pass), each in float64 integers, exact.
- Trunk: ResNet-50 with the stride in the 1x1 convolution and
  FrozenBatchNorm, FPN P2-P5 with nearest 2x top-down, P6 a stride-2 pool
  of P5.
- Proposals: anchors of sizes 32-512 at ratios 0.5, 1, 2 (offset 0); each
  level's top 1,000 by objectness, decoded (weights 1, scale clamp
  log(1000/16)), clipped, empty boxes dropped, NMS at 0.7 within each level,
  the first `post_nms_topk`.
- Box head: ROIAlignV2 (aligned, adaptive sampling) at 7x7 over P2-P5
  (level floor(4 + log2(sqrt(area) / 224 + 1e-8))), two FCs of 1024, the
  person's softmax score over 0.05, box decode (weights 10, 10, 5, 5), NMS
  at 0.5, the first `max_detections`.
- Keypoint head: ROIAlignV2 at 14x14, eight 3x3 convolutions of 512, the
  4x4 stride-2 transposed convolution, bilinear 2x, and
  `heatmaps_to_keypoints` (a bicubic resize of each ROI's maps to its
  integer size, the first maximum, x1 + (x + 0.5) w / ceil(w)).
- PointRend: the coarse head on P2 sampled at a regular 14x14 grid of each
  box, then detectron2's subdivision (bilinear 2x, the 28x28 most
  uncertain points re-predicted from P2 and the coarse logits by the point
  head; a step skipped where the next would re-predict every point), and
  `paste_masks_in_image` (`grid_sample` at the pixel centres, >= 0.5).
- Selection: STRAPS's largest roughly centred box and mask.

Departures from detectron2 (and STRAPS), each also the port's:

- The budgets: `post_nms_topk` and `max_detections` are the
  configuration's (512 and 8), where detectron2 keeps 1,000 proposals and
  100 detections.
- Only the person class is scored, boxed, refined and pasted: STRAPS keeps
  the class-0 instances alone.  Its NMS therefore never meets boxes of
  other classes, which detectron2's class-wise NMS would leave in place
  and count towards the 100.
- Keypoints are decoded against the boxes in the output frame (512), as
  the port and the JAX package do; detectron2 decodes them at the
  network's 800 and scales x and y by 512 / 800, which moves a joint by
  up to about half a pixel of the 512 frame.
- Ties are broken in index order: the per-level top-k, NMS's score order
  and the uncertain points (detectron2's `torch.topk` leaves them open),
  and the selection's area order (STRAPS's `np.argsort(a)[::-1]` takes the
  later of equal areas first; the port the earlier).
- NMS keeps levels apart by a level test, not by torchvision's coordinate
  offset, whose rounding can move an IoU by an ulp.
- An image without detections gives a zero silhouette and zero joints
  (STRAPS raises on it).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_MEAN_BGR = (103.53, 116.28, 123.675)
FRAME = 512
TEST_SIZE = 800
STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
PRE_NMS_TOPK = 1000
RPN_NMS = 0.7
BOX_NMS = 0.5
SCALE_CLAMP = math.log(1000.0 / 16)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SUBDIVISION_STEPS = 5
SUBDIVISION_POINTS = 28 * 28
COARSE_SIDE = 14
# Boxes gathered at once in ROIAlign: bounds the samples' memory.
ROI_CHUNK = 32


# ------------------------------------------------------------ images --

def pad_to_square(img: np.ndarray) -> np.ndarray:
    """STRAPS's `pad_to_square`: zero borders of half the difference on
    the short sides."""
    h, w = img.shape[:2]
    if w < h:
        b = (h - w) // 2
        return np.pad(img, ((0, 0), (b, b), (0, 0)))
    b = (w - h) // 2
    return np.pad(img, ((b, b), (0, 0), (0, 0)))


def _cv2_taps(src: int, dst: int, clamp: bool):
    scale = 1.0 / (dst / src)
    f = torch.tensor([np.float32((d + 0.5) * scale - 0.5) for d in range(dst)],
                     dtype=torch.float32)
    s = torch.floor(f)
    frac = f - s
    s = s.to(torch.int64)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        frac = torch.where(edge, torch.zeros_like(frac), frac)
        s = torch.where(s < 0, torch.zeros_like(s), torch.where(s >= src - 1,
                                                                torch.full_like(s, src - 1), s))
    w1 = torch.round(frac * 2048.0).double()                 # cvRound: half to even
    w0 = torch.round((1.0 - frac) * 2048.0).double()
    return s.clamp(0, src - 1), (s + 1).clamp(0, src - 1), w0, w1


def cv2_resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)` of a
    uint8 (H, W, C) image, in float64 integers."""
    x = torch.as_tensor(np.ascontiguousarray(img)).double()
    h, w, c = x.shape
    if h == 2 * size and w == 2 * size:
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return torch.floor((s + 2.0) / 4.0).to(torch.uint8).numpy()
    x0, x1, a0, a1 = _cv2_taps(w, size, True)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    y0, y1, b0, b1 = _cv2_taps(h, size, False)
    t0 = torch.floor(torch.floor(rows[y0] / 16.0) * b0[:, None, None] / 65536.0)
    t1 = torch.floor(torch.floor(rows[y1] / 16.0) * b1[:, None, None] / 65536.0)
    out = torch.floor((t0 + t1 + 2.0) / 4.0)
    return out.clamp(0, 255).to(torch.uint8).numpy()


def _pil_coeffs(src: int, dst: int):
    """Pillow's bilinear taps of one axis: per output pixel the first
    input index and the 22-bit integer weights."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    firsts, weights = [], []
    ss = 1.0 / filterscale
    for xx in range(dst):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        ks = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = sum(ks)
        ks = [k / total for k in ks] if total else ks
        firsts.append(xmin)
        weights.append([int(k * (1 << 22) + (-0.5 if k < 0 else 0.5)) for k in ks])
    return firsts, weights


def _pil_pass(x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
    firsts, weights = _pil_coeffs(x.shape[dim], dst)
    n = max(len(w) for w in weights)
    idx = torch.tensor([[min(f + k, x.shape[dim] - 1) for k in range(n)] for f in firsts])
    wt = torch.tensor([w + [0] * (n - len(w)) for w in weights], dtype=torch.float64)
    m = x.movedim(dim, 0)
    acc = torch.full((dst,) + m.shape[1:], float(1 << 21), dtype=torch.float64)
    tail = (1,) * (m.dim() - 1)
    for k in range(n):
        acc = acc + m[idx[:, k]] * wt[:, k].view((-1,) + tail)
    return torch.floor(acc / float(1 << 22)).clamp(0, 255).movedim(0, dim)


def pil_resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """`Image.resize((size, size), Image.BILINEAR)` of a uint8 (H, W, C)
    image (detectron2's ResizeShortestEdge), in float64 integers."""
    x = torch.as_tensor(np.ascontiguousarray(img)).double()
    if x.shape[1] != size:
        x = _pil_pass(x, 1, size)
    if x.shape[0] != size:
        x = _pil_pass(x, 0, size)
    return x.to(torch.uint8).numpy()


def network_input(img_rgb: np.ndarray, test_size: int, device) -> torch.Tensor:
    """A 512-frame uint8 RGB image -> (1, 3, S, S) float32 BGR minus
    detectron2's pixel mean, at the test size."""
    x = pil_resize_bilinear(img_rgb, test_size) if test_size else img_rgb
    bgr = torch.as_tensor(np.ascontiguousarray(x[..., ::-1]), device=device).float()
    bgr = bgr - torch.tensor(PIXEL_MEAN_BGR, device=device)
    return bgr.permute(2, 0, 1)[None].contiguous()


# ------------------------------------------------------------- trunk --

def _conv(x, sd, name, stride=1, padding=0, norm=True):
    w = sd[name + ".weight"].to(x.dtype)
    b = sd.get(name + ".bias")
    x = F.conv2d(x, w, None if b is None else b.to(x.dtype), stride, padding)
    if norm:
        scale = sd[name + ".norm.weight"] / torch.sqrt(sd[name + ".norm.running_var"] + 1e-5)
        shift = sd[name + ".norm.bias"] - sd[name + ".norm.running_mean"] * scale
        x = x * scale.view(1, -1, 1, 1).to(x.dtype) + shift.view(1, -1, 1, 1).to(x.dtype)
    return x


def _bottleneck(x, sd, p, stride):
    out = F.relu(_conv(x, sd, p + ".conv1", stride))
    out = F.relu(_conv(out, sd, p + ".conv2", 1, 1))
    out = _conv(out, sd, p + ".conv3")
    short = _conv(x, sd, p + ".shortcut", stride) if p + ".shortcut.weight" in sd else x
    return F.relu(out + short)


def trunk(image, sd, dtype=torch.float32):
    """ResNet-50 + FPN: [P2, P3, P4, P5, P6] float32 (computed in `dtype`)."""
    x = image.to(dtype)
    x = F.max_pool2d(F.relu(_conv(x, sd, "backbone.bottom_up.stem.conv1", 2, 3)), 3, 2, 1)
    stages = []
    for s in range(2, 6):
        b = 0
        while f"backbone.bottom_up.res{s}.{b}.conv1.weight" in sd:
            x = _bottleneck(x, sd, f"backbone.bottom_up.res{s}.{b}",
                            2 if s > 2 and b == 0 else 1)
            b += 1
        stages.append(x)
    lat = [_conv(c, sd, f"backbone.fpn_lateral{i + 2}", norm=False) for i, c in enumerate(stages)]
    prev = lat[3]
    outs = [_conv(prev, sd, "backbone.fpn_output5", 1, 1, norm=False)]
    for i in (2, 1, 0):
        prev = lat[i] + F.interpolate(prev, scale_factor=2.0, mode="nearest")
        outs.insert(0, _conv(prev, sd, f"backbone.fpn_output{i + 2}", 1, 1, norm=False))
    outs.append(F.max_pool2d(outs[3], kernel_size=1, stride=2, padding=0))
    return [o.float() for o in outs]


# --------------------------------------------------------- proposals --

def anchors(feat_h, feat_w, stride, size, device):
    """detectron2's DefaultAnchorGenerator for one level (offset 0)."""
    cell = []
    for ar in ASPECT_RATIOS:
        w = math.sqrt(size * size / ar)
        h = ar * w
        cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    sx = torch.arange(0, feat_w * stride, step=stride, dtype=torch.float32, device=device)
    sy = torch.arange(0, feat_h * stride, step=stride, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([xx.reshape(-1), yy.reshape(-1), xx.reshape(-1), yy.reshape(-1)], 1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


def apply_deltas(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """detectron2's `Box2BoxTransform.apply_deltas` for (N, 4) deltas."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[:, 3] / wh, max=SCALE_CLAMP)
    cx = dx * widths + ctr_x
    cy = dy * heights + ctr_y
    w = torch.exp(dw) * widths
    h = torch.exp(dh) * heights
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=1)


def clip(boxes, size):
    return torch.stack([boxes[:, 0].clamp(0, size), boxes[:, 1].clamp(0, size),
                        boxes[:, 2].clamp(0, size), boxes[:, 3].clamp(0, size)], dim=1)


def nms(boxes, scores, thresh, groups=None, limit=None):
    """Greedy NMS, the textbook loop on the host: the best remaining box is
    kept and suppresses every box of its group whose IoU with it exceeds
    `thresh`.  Returns the kept indices in score order (at most `limit`)."""
    b = boxes.detach().cpu().numpy().astype(np.float32)
    s = scores.detach().cpu().numpy()
    g = None if groups is None else groups.detach().cpu().numpy()
    order = np.argsort(-s, kind="stable")
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    suppressed = np.zeros(len(s), bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        if limit is not None and len(keep) == limit:
            break
        iw = np.maximum(np.minimum(b[i, 2], b[:, 2]) - np.maximum(b[i, 0], b[:, 0]),
                        np.float32(0))
        ih = np.maximum(np.minimum(b[i, 3], b[:, 3]) - np.maximum(b[i, 1], b[:, 1]),
                        np.float32(0))
        inter = iw * ih
        over = inter / (area[i] + area - inter) > thresh
        if g is not None:
            over &= g == g[i]
        suppressed |= over
    return torch.tensor(keep, dtype=torch.int64, device=boxes.device)


def proposals(feats, sd, img_size, post_nms_topk):
    """The RPN of one image: (P, 4) boxes in score order."""
    p = "proposal_generator.rpn_head"
    boxes, scores, levels = [], [], []
    for lvl, f in enumerate(feats):
        t = F.relu(_conv(f, sd, p + ".conv", 1, 1, norm=False))
        logits = _conv(t, sd, p + ".objectness_logits", norm=False)[0]      # (A, H, W)
        deltas = _conv(t, sd, p + ".anchor_deltas", norm=False)[0]          # (4A, H, W)
        A, H, W = logits.shape
        logits = logits.permute(1, 2, 0).reshape(-1)
        deltas = deltas.view(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
        k = min(PRE_NMS_TOPK, logits.numel())
        top = torch.sort(logits, descending=True, stable=True).indices[:k]
        anc = anchors(H, W, STRIDES[lvl], ANCHOR_SIZES[lvl], f.device)
        boxes.append(clip(apply_deltas(deltas[top], anc[top]), img_size))
        scores.append(logits[top])
        levels.append(torch.full((k,), lvl, device=f.device))
    boxes, scores, levels = torch.cat(boxes), torch.cat(scores), torch.cat(levels)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    boxes, scores, levels = boxes[keep], scores[keep], levels[keep]
    return boxes[nms(boxes, scores, RPN_NMS, levels, post_nms_topk)]


# ---------------------------------------------------------- ROIAlign --

def _bilinear(feat, y, x):
    """torchvision's `bilinear_interpolate` of (C, H, W) at (R, Ny, Nx)
    sample points given as y (R, Ny, 1) and x (R, 1, Nx) -> (R, C, Ny, Nx)."""
    C, H, W = feat.shape
    y = y.expand(-1, -1, x.shape[2])
    x = x.expand(-1, y.shape[1], -1)
    out_of_map = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = y.floor().long()
    x_low = x.floor().long()
    y_top = y_low >= H - 1
    x_top = x_low >= W - 1
    y_low = torch.where(y_top, torch.full_like(y_low, H - 1), y_low)
    x_low = torch.where(x_top, torch.full_like(x_low, W - 1), x_low)
    y = torch.where(y_top, y_low.float(), y)
    x = torch.where(x_top, x_low.float(), x)
    y_high = torch.where(y_top, y_low, y_low + 1)
    x_high = torch.where(x_top, x_low, x_low + 1)
    ly, lx = y - y_low, x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(C, H * W)

    def tap(yi, xi):
        return flat[:, (yi * W + xi).reshape(-1)].view(C, *yi.shape).permute(1, 0, 2, 3)

    val = ((hy * hx)[:, None] * tap(y_low, x_low) + (hy * lx)[:, None] * tap(y_low, x_high)
           + (ly * hx)[:, None] * tap(y_high, x_low) + (ly * lx)[:, None] * tap(y_high, x_high))
    return torch.where(out_of_map[:, None], torch.zeros_like(val), val)


def roi_align(feat, boxes, scale, out):
    """torchvision's `roi_align(aligned=True, sampling_ratio=0)` of (C, H, W)
    over (R, 4) boxes -> (R, C, out, out): each bin the mean of a
    ceil(roi / out) x ceil(roi / out) grid of bilinear samples."""
    R = boxes.shape[0]
    res = feat.new_zeros(R, feat.shape[0], out, out)
    x1 = boxes[:, 0] * scale - 0.5
    y1 = boxes[:, 1] * scale - 0.5
    rw = (boxes[:, 2] * scale - 0.5) - x1
    rh = (boxes[:, 3] * scale - 0.5) - y1
    gw = torch.ceil(rw / out).long()
    gh = torch.ceil(rh / out).long()
    grids = sorted(set(zip(gh.tolist(), gw.tolist())))
    for g_h, g_w in grids:
        idx = ((gh == g_h) & (gw == g_w)).nonzero().flatten()
        for c in range(0, len(idx), ROI_CHUNK):
            r = idx[c:c + ROI_CHUNK]
            if g_h <= 0 or g_w <= 0:
                continue                          # torchvision's count of 0 samples: zeros
            bh, bw = rh[r] / out, rw[r] / out
            ph = torch.arange(out, device=feat.device).float()
            iy = torch.arange(g_h, device=feat.device).float()
            ix = torch.arange(g_w, device=feat.device).float()
            ys = (y1[r, None, None] + ph[None, :, None] * bh[:, None, None]
                  + (iy[None, None, :] + 0.5) * bh[:, None, None] / g_h).reshape(len(r), -1, 1)
            xs = (x1[r, None, None] + ph[None, :, None] * bw[:, None, None]
                  + (ix[None, None, :] + 0.5) * bw[:, None, None] / g_w).reshape(len(r), 1, -1)
            v = _bilinear(feat, ys, xs)                              # (r, C, out*gh, out*gw)
            v = v.view(len(r), -1, out, g_h, out, g_w).sum(dim=(3, 5)) / float(g_h * g_w)
            res[r] = v
    return res


def pool(feats, boxes, out):
    """ROIPooler over P2-P5: each box pooled from its level only."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8)).clamp(2, 5).long() - 2
    res = feats[0].new_zeros(boxes.shape[0], feats[0].shape[1], out, out)
    for k in range(4):
        idx = (lvl == k).nonzero().flatten()
        if len(idx):
            res[idx] = roi_align(feats[k][0], boxes[idx], 1.0 / STRIDES[k], out)
    return res


# -------------------------------------------------------------- heads --

def _fc(x, sd, name):
    return F.linear(x, sd[name + ".weight"], sd[name + ".bias"])


def detect(feats, sd, props, img_size, score_thresh, max_detections):
    """The box head and its inference for the person class: (D, 4) boxes
    in the network frame."""
    x = pool(feats, props, 7).flatten(1)
    x = F.relu(_fc(F.relu(_fc(x, sd, "roi_heads.box_head.fc1")), sd, "roi_heads.box_head.fc2"))
    probs = torch.softmax(_fc(x, sd, "roi_heads.box_predictor.cls_score"), dim=1)[:, 0]
    deltas = _fc(x, sd, "roi_heads.box_predictor.bbox_pred")[:, :4]
    boxes = clip(apply_deltas(deltas, props, BOX_WEIGHTS), img_size)
    ok = torch.isfinite(boxes).all(dim=1) & torch.isfinite(probs) & (probs > score_thresh)
    boxes, probs = boxes[ok], probs[ok]
    return boxes[nms(boxes, probs, BOX_NMS, None, max_detections)]


def heatmaps_to_keypoints(maps, rois):
    """detectron2's `heatmaps_to_keypoints`: (R, K, 56, 56), (R, 4) -> (R, K, 2)."""
    widths = (rois[:, 2] - rois[:, 0]).clamp(min=1)
    heights = (rois[:, 3] - rois[:, 1]).clamp(min=1)
    wc, hc = widths.ceil(), heights.ceil()
    out = maps.new_zeros(rois.shape[0], maps.shape[1], 2)
    for i in range(rois.shape[0]):
        size = (int(hc[i]), int(wc[i]))
        roi_map = F.interpolate(maps[[i]], size=size, mode="bicubic", align_corners=False)[0]
        w = roi_map.shape[2]
        pos = roi_map.reshape(maps.shape[1], -1).argmax(1)
        x_int = pos % w
        y_int = (pos - x_int) // w
        out[i, :, 0] = (x_int.float() + 0.5) * (widths[i] / wc[i]) + rois[i, 0]
        out[i, :, 1] = (y_int.float() + 0.5) * (heights[i] / hc[i]) + rois[i, 1]
    return out


def keypoints(feats, sd, boxes, scale):
    """The keypoint head on (D, 4) boxes of the network frame -> (D, 17, 2)
    joints in the output frame (`scale` = output / network)."""
    x = pool(feats, boxes, 14)
    i = 1
    while f"roi_heads.keypoint_head.conv_fcn{i}.weight" in sd:
        x = F.relu(_conv(x, sd, f"roi_heads.keypoint_head.conv_fcn{i}", 1, 1, norm=False))
        i += 1
    p = "roi_heads.keypoint_head.score_lowres"
    x = F.conv_transpose2d(x, sd[p + ".weight"], sd[p + ".bias"], stride=2, padding=1)
    maps = F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)
    return heatmaps_to_keypoints(maps, boxes * scale)


def point_sample(x, coords):
    """detectron2's `point_sample`: (R, C, H, W) at (R, P, 2) points in
    [0, 1] -> (R, C, P) (`grid_sample`, zero padding)."""
    return F.grid_sample(x, 2.0 * coords[:, :, None, :] - 1.0, align_corners=False)[..., 0]


def fine_features(p2, boxes, coords, stride=4):
    """P2 of one image at points of boxes in the image frame: the points'
    image coordinates over the map's extent times its stride."""
    xy = torch.stack([coords[..., 0] * (boxes[:, None, 2] - boxes[:, None, 0]) + boxes[:, None, 0],
                      coords[..., 1] * (boxes[:, None, 3] - boxes[:, None, 1]) + boxes[:, None, 1]],
                     dim=-1)
    H, W = p2.shape[-2:]
    scaled = xy / torch.tensor([W * stride, H * stride], dtype=torch.float32, device=p2.device)
    return F.grid_sample(p2.expand(boxes.shape[0], -1, -1, -1), 2.0 * scaled[:, :, None, :] - 1.0,
                         align_corners=False)[..., 0]


def _point_head(fine, coarse, sd):
    p = "roi_heads.mask_point_head"
    x = torch.cat([fine, coarse], dim=1)
    i = 1
    while f"{p}.fc{i}.weight" in sd:
        x = torch.cat([F.relu(F.conv1d(x, sd[f"{p}.fc{i}.weight"], sd[f"{p}.fc{i}.bias"])),
                       coarse], dim=1)
        i += 1
    return F.conv1d(x, sd[p + ".predictor.weight"], sd[p + ".predictor.bias"])


def masks(feats, sd, boxes, steps=SUBDIVISION_STEPS):
    """PointRend on (D, 4) boxes of the network frame: the person's mask
    probabilities (D, 7 * 2**steps, 7 * 2**steps)."""
    D = boxes.shape[0]
    side = COARSE_SIDE
    grid = (torch.arange(side, dtype=torch.float32, device=boxes.device) + 0.5) / side
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).expand(D, -1, -1)
    x = fine_features(feats[0], boxes, coords).view(D, -1, side, side)
    p = "roi_heads.mask_coarse_head"
    x = F.relu(F.conv2d(x, sd[p + ".reduce_spatial_dim_conv.weight"],
                        sd[p + ".reduce_spatial_dim_conv.bias"], stride=2))
    x = F.relu(_fc(F.relu(_fc(x.flatten(1), sd, p + ".coarse_mask_fc1")), sd,
                   p + ".coarse_mask_fc2"))
    coarse = _fc(x, sd, p + ".prediction").view(D, -1, 7, 7)
    logits = coarse[:, :1]
    for step in range(steps):
        logits = F.interpolate(logits, scale_factor=2, mode="bilinear", align_corners=False)
        H, W = logits.shape[-2:]
        if SUBDIVISION_POINTS >= 4 * H * W and step < steps - 1:
            continue
        n = min(H * W, SUBDIVISION_POINTS)
        idx = torch.sort(-logits.abs().view(D, H * W), dim=1, descending=True,
                         stable=True).indices[:, :n]
        pts = torch.stack([0.5 / W + (idx % W).float() * (1.0 / W),
                           0.5 / H + (idx // W).float() * (1.0 / H)], dim=-1)
        new = _point_head(fine_features(feats[0], boxes, pts), point_sample(coarse, pts), sd)
        logits = logits.reshape(D, 1, H * W).scatter(2, idx[:, None], new[:, :1]).view(D, 1, H, W)
    return torch.sigmoid(logits[:, 0])


def paste(probs, boxes, size):
    """detectron2's `paste_masks_in_image` at threshold 0.5: (D, S, S),
    (D, 4) in the output frame -> (D, size, size) bool."""
    D = probs.shape[0]
    ys = torch.arange(size, dtype=torch.float32, device=probs.device) + 0.5
    xs = torch.arange(size, dtype=torch.float32, device=probs.device) + 0.5
    x0, y0, x1, y1 = boxes.split(1, dim=1)
    img_y = (ys[None] - y0) / (y1 - y0) * 2 - 1
    img_x = (xs[None] - x0) / (x1 - x0) * 2 - 1
    gx = img_x[:, None, :].expand(D, size, size)
    gy = img_y[:, :, None].expand(D, size, size)
    out = F.grid_sample(probs[:, None], torch.stack([gx, gy], dim=3), align_corners=False)
    return out[:, 0] >= 0.5


# ---------------------------------------------------------- the calls --

def run_keypoint_rcnn(image, sd, post_nms_topk, max_detections, score_thresh=0.05,
                      out_size=FRAME, trunk_dtype=torch.float32):
    """One (1, 3, S, S) network input -> (D, 4) boxes and (D, 17, 2) joints
    in the `out_size` frame."""
    S = image.shape[-1]
    feats = trunk(image, sd, trunk_dtype)
    boxes = detect(feats, sd, proposals(feats, sd, S, post_nms_topk), S, score_thresh,
                   max_detections)
    scale = out_size / S
    if len(boxes) == 0:
        return boxes, boxes.new_zeros(0, 17, 2)
    return boxes * scale, keypoints(feats, sd, boxes, scale)


def run_pointrend(image, sd, post_nms_topk, max_detections, score_thresh=0.05, out_size=FRAME,
                  trunk_dtype=torch.float32, steps=SUBDIVISION_STEPS):
    """One (1, 3, S, S) network input -> (D, 4) boxes and (D, out, out)
    bool masks in the `out_size` frame."""
    S = image.shape[-1]
    feats = trunk(image, sd, trunk_dtype)
    boxes = detect(feats, sd, proposals(feats, sd, S, post_nms_topk), S, score_thresh,
                   max_detections)
    out_boxes = boxes * (out_size / S)
    if len(boxes) == 0:
        return out_boxes, torch.zeros((0, out_size, out_size), dtype=torch.bool,
                                      device=boxes.device)
    return out_boxes, paste(masks(feats, sd, boxes, steps), out_boxes, out_size)


def largest_centred_box(boxes: np.ndarray, w: int, h: int) -> int:
    """STRAPS's `get_largest_centred_bounding_box` (ties in index order)."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = np.argsort(-area, kind="stable")
    for i in order:
        cx, cy = (boxes[i, 0] + boxes[i, 2]) / 2.0, (boxes[i, 1] + boxes[i, 3]) / 2.0
        if abs(cx - w / 2.0) < w / 6.0 and abs(cy - h / 2.0) < w / 6.0:
            return int(i)
    return int(order[0])


def largest_centred_mask(masks_: np.ndarray, w: int, h: int) -> int:
    """STRAPS's `get_largest_centred_mask` (ties in index order; empty
    masks passed over)."""
    area = masks_.sum(axis=(1, 2))
    order = np.argsort(-area, kind="stable")
    for i in order:
        if area[i] == 0:
            continue
        rows, cols = np.nonzero(masks_[i])
        cr, cc = (rows.min() + rows.max()) / 2.0, (cols.min() + cols.max()) / 2.0
        if abs(cr - h / 2.0) < w / 4.0 and abs(cc - w / 2.0) < w / 6.0:
            return int(i)
    return int(order[0])


@torch.no_grad()
def proxies_of(images, kp_sd, pr_sd, post_nms_topk, max_detections, score_thresh=0.05,
               test_size=TEST_SIZE, out_size=FRAME, trunk_dtype=torch.float32):
    """512-frame uint8 RGB images [(512, 512, 3)] -> the selected person's
    silhouettes (N, 512, 512) float32 and joints (N, 17, 2), numpy."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = next(iter(kp_sd.values())).device
    sils, joints = [], []
    for img in images:
        x = network_input(img, test_size, dev)
        boxes, kps = run_keypoint_rcnn(x, kp_sd, post_nms_topk, max_detections, score_thresh,
                                       out_size, trunk_dtype)
        boxes, kps = boxes.cpu().numpy(), kps.cpu().numpy()
        kp_sel = None if len(boxes) == 0 else largest_centred_box(boxes, out_size, out_size)
        joints.append(np.zeros((17, 2), np.float32) if kp_sel is None else kps[kp_sel])
        _, ms = run_pointrend(x, pr_sd, post_nms_topk, max_detections, score_thresh,
                              out_size, trunk_dtype)
        ms = ms.cpu().numpy()
        pr_sel = None if len(ms) == 0 else largest_centred_mask(ms, out_size, out_size)
        sils.append(np.zeros((out_size, out_size), np.float32) if pr_sel is None
                    else ms[pr_sel].astype(np.float32))
    return np.stack(sils), np.stack(joints).astype(np.float32)
