"""matplotlib's figures of the predict path without matplotlib
(counterparts of `verts_over_image_vis` and `scatter_vis` in
`straps_tpu/render/vis.py`), computed with torch on the inputs' device.

Each reproduces what matplotlib 3.10's Agg backend draws for the
reference's calls, step by step:

* the figures' layout: the default 6.4 x 4.8 in figure at 100 dpi with
  the image's equal-aspect axes, or mplot3d's 4 x 4 in axes with its
  limits, projection, panes, grid, axis and tick lines;
* Agg's resampling of an image (`span_image_resample_rgba_affine`: its
  normalised 14-bit filter table, taps at 1/256 px, the 2D weight rounded
  from the product of the 1D weights, the sum divided by the total weight
  and truncated; edges reflected), with the 'auto' interpolation's choice
  of a Hanning filter or nearest neighbour;
* Agg's stroker (caps, miter and round joins) and its scanline
  rasteriser: a pixel's coverage is the path's area in it, on a 1/256
  pixel grid;
* markers: the fill and the stroke of each, blended one after the other
  in drawing order with Agg's integer RGBA blender.  `scatter(s=0.3)`
  draws one cached marker at offsets rounded to a pixel (the stamps
  `_MARKER_*_03`); the 3D scatter draws each marker at its own offset
  (its areas interpolated in a table of the marker at 1/32 px offsets,
  `_marker_area_table`).

The tick labels of the 3D figure are not drawn (no font rasteriser).
"""

import math
from typing import Tuple

import numpy as np
import torch

from straps_tpu_torch.utils.png import write_png

FIG_W, FIG_H = 640, 480          # rcParams figure.figsize (6.4, 4.8) at 100 dpi
C0 = (31, 119, 180)              # the first colour of the default cycle, '#1f77b4'

_SUBPIXEL = 256                  # Agg image_subpixel_scale
_FILTER_SCALE = 1 << 14          # Agg image_filter_scale


def _iround(v: float) -> int:
    return int(v - 0.5) if v < 0 else int(v + 0.5)


def _hanning_lut() -> np.ndarray:
    """Agg's `image_filter_lut` of the Hanning filter (radius 1): 512
    int16 weights over filter positions -1..1 in steps of 1/256,
    normalised so that the two taps of every subpixel phase sum to 2^14
    (`image_filter_lut::normalize`, as matplotlib's filternorm asks)."""
    diameter, pivot = 2, 256
    w = np.zeros(diameter * _SUBPIXEL, np.int64)
    for i in range(pivot):
        y = 0.5 + 0.5 * math.cos(math.pi * i / _SUBPIXEL)
        w[pivot + i] = w[pivot - i] = _iround(y * _FILTER_SCALE)
    w[0] = w[-1]
    flip = 1
    for i in range(_SUBPIXEL):
        while True:
            total = sum(int(w[j * _SUBPIXEL + i]) for j in range(diameter))
            if total == _FILTER_SCALE:
                break
            k = _FILTER_SCALE / total
            total = 0
            for j in range(diameter):
                w[j * _SUBPIXEL + i] = _iround(w[j * _SUBPIXEL + i] * k)
                total += int(w[j * _SUBPIXEL + i])
            total -= _FILTER_SCALE
            inc = -1 if total > 0 else 1
            for j in range(diameter):
                if not total:
                    break
                flip ^= 1
                idx = diameter // 2 + j // 2 if flip else diameter // 2 - j // 2
                if w[idx * _SUBPIXEL + i] < _FILTER_SCALE:
                    w[idx * _SUBPIXEL + i] += inc
                    total += inc
    for i in range(pivot):
        w[pivot + i] = w[pivot - i]
    w[0] = w[-1]
    return w


_HANNING = _hanning_lut()


def _reflect(k: torch.Tensor, n: int) -> torch.Tensor:
    """Agg's `wrap_mode_reflect`: index k of a row of n pixels, reflected
    at both ends with the edge pixel repeated."""
    m = torch.remainder(k, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def _scale_radius(scale: float) -> Tuple[int, int]:
    """`span_image_resample_affine::prepare` for one axis: the filter's
    widening for a downsampling of `scale` input pixels per output pixel
    (at least 1), as (m_rx, m_rx_inv) in 1/256 units."""
    scale = min(max(scale, 1.0), 20.0)
    return int(scale * _SUBPIXEL + 0.5), int(1.0 / scale * _SUBPIXEL + 0.5)


def _filter_taps(coord: torch.Tensor, n_in: int, scale: float):
    """Source pixels and integer weights of Agg's resampling filter for
    output samples at input coordinates `coord` (float64, pixel k covering
    [k, k + 1)) along one axis: (N, T) indices (reflected) and (N, T)
    weights, 0 for unused taps."""
    rx, rx_inv = _scale_radius(scale)
    x = torch.round(coord * _SUBPIXEL).to(torch.int64) + _SUBPIXEL // 2 - rx
    first = torch.div(x, _SUBPIXEL, rounding_mode="floor")
    hr0 = ((_SUBPIXEL - 1 - torch.remainder(x, _SUBPIXEL)) * rx_inv) >> 8
    taps = (2 * _SUBPIXEL) // rx_inv + 2
    t = torch.arange(taps, device=coord.device)
    hr = hr0[:, None] + t[None, :] * rx_inv
    lut = torch.as_tensor(_HANNING, device=coord.device)
    w = torch.where(hr < 2 * _SUBPIXEL, lut[hr.clamp(max=2 * _SUBPIXEL - 1)], 0)
    return _reflect(first[:, None] + t[None, :], n_in), w


def agg_resample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 scale_u: float, scale_v: float, hanning: bool) -> torch.Tensor:
    """Resample a uint8 (H, W, C) image at the input coordinates u (columns,
    length W_out) and v (rows, H_out) of an axis-aligned transform with
    `scale_*` input pixels per output pixel -> uint8 (H_out, W_out, C):
    Agg's `span_image_resample_rgba_affine` with the Hanning table, or its
    nearest neighbour."""
    H, W = image.shape[:2]
    if not hanning:
        cols = _reflect(torch.div(torch.round(u * _SUBPIXEL).to(torch.int64), _SUBPIXEL,
                                  rounding_mode="floor"), W)
        rows = _reflect(torch.div(torch.round(v * _SUBPIXEL).to(torch.int64), _SUBPIXEL,
                                  rounding_mode="floor"), H)
        return image[rows][:, cols]
    kx, wx = _filter_taps(u, W, scale_u)                     # (W_out, Tx)
    ky, wy = _filter_taps(v, H, scale_v)                     # (H_out, Ty)
    img = image.to(torch.int64)
    acc = torch.zeros(len(v), len(u), image.shape[2], dtype=torch.int64, device=image.device)
    total = torch.zeros(len(v), len(u), dtype=torch.int64, device=image.device)
    for a in range(ky.shape[1]):
        rows = img[ky[:, a]]                                 # (H_out, W, C)
        for b in range(kx.shape[1]):
            w = (wy[:, a, None] * wx[None, :, b] + _FILTER_SCALE // 2) >> 14
            acc += w[..., None] * rows[:, kx[:, b]]
            total += w
    out = torch.div(acc, total[..., None].clamp(min=1), rounding_mode="floor")
    return out.clamp(0, 255).to(torch.uint8)


def blend_sequence(canvas: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
                   alpha: torch.Tensor, color) -> torch.Tensor:
    """Blend `color` over an opaque canvas at flat pixel indices `idx` with
    Agg's plain RGBA blender (8-bit alphas `alpha`), each pixel's blends in
    the order of `order`, as Agg draws one marker after the other: the
    k-th blends of all pixels go together, one round each.  Returns the new
    canvas."""
    H, W = canvas.shape[:2]
    keep = alpha > 0
    idx, order, alpha = idx[keep], order[keep], alpha[keep]
    rgb = canvas[..., :3].reshape(H * W, 3).to(torch.int64)
    if len(idx):
        perm = torch.argsort(idx * (int(order.max()) + 1) + order)
        idx, alpha = idx[perm], alpha[perm]
        rank = torch.arange(len(idx), device=idx.device) - torch.searchsorted(idx, idx)
        by_rank = torch.argsort(rank, stable=True)
        idx, alpha = idx[by_rank], alpha[by_rank][:, None]
        col = torch.tensor(color, dtype=torch.int64, device=canvas.device)
        start = 0
        for count in torch.bincount(rank).tolist():
            at, a = idx[start:start + count], alpha[start:start + count]
            p = rgb[at]
            rgb[at] = torch.div((col * 256 - p * 255) * a + p * 255 * 256, a + 65280,
                                rounding_mode="floor")
            start += count
    out = canvas.clone()
    out[..., :3] = rgb.view(H, W, 3).to(torch.uint8)
    return out


# The marker `scatter(..., s=0.3)` draws at 100 dpi: a disc of diameter
# sqrt(0.3) pt filled, then stroked 1.5 pt wide in the same colour, as Agg
# rasterises them centred on a pixel: blend alphas (0-255) at row and
# column offsets -1..1.
_MARKER_FILL_03 = ((0, 0, 0), (0, 115, 0), (0, 0, 0))
_MARKER_STROKE_03 = ((31, 136, 31), (136, 191, 136), (31, 136, 31))


def stamp_markers(canvas: torch.Tensor, x_disp: torch.Tensor, y_disp: torch.Tensor,
                  stamps, color, clip: Tuple[int, int, int, int]) -> torch.Tensor:
    """Draw one marker at each display position (x right, y up, float64)
    onto the uint8 (FIG_H, FIG_W, 3|4) canvas, in order, as Agg's
    draw_markers does: the marker at pixel (floor(FIG_H - y + 0.5),
    floor(x + 0.5)), each stamp of `stamps` ((K, K) blend alphas, centred)
    in turn, clipped to `clip` = (col0, row0, col1, row1), exclusive ends."""
    dev = canvas.device
    col = torch.floor(x_disp + 0.5).to(torch.int64)
    row = torch.floor(FIG_H - y_disp + 0.5).to(torch.int64)
    n = len(col)
    idx, order, alpha = [], [], []
    for phase, stamp in enumerate(stamps):
        st = torch.as_tensor(np.asarray(stamp), device=dev)
        r = st.shape[0] // 2
        dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                                torch.arange(-r, r + 1, device=dev), indexing="ij")
        keep = st > 0
        a, dy, dx = st[keep], dy[keep], dx[keep]
        rr = row[:, None] + dy[None]
        cc = col[:, None] + dx[None]
        inside = (rr >= clip[1]) & (rr < clip[3]) & (cc >= clip[0]) & (cc < clip[2])
        idx.append((rr * FIG_W + cc)[inside])
        seq = torch.arange(n, device=dev)[:, None] * len(stamps) + phase
        order.append(seq.expand(-1, len(a))[inside])
        alpha.append(a[None].expand(n, -1)[inside])
    return blend_sequence(canvas, torch.cat(idx), torch.cat(order), torch.cat(alpha), color)


def _equal_aspect_box(xlim, ylim) -> Tuple[float, float, float, float]:
    """The axes' box (x0, y0, width, height) in display pixels (y up) of
    axes spanning the whole figure with equal aspect, adjustable 'box' and
    anchor 'C' (`Axes.apply_aspect`, `Bbox.shrunk_to_aspect`)."""
    box_aspect = abs(ylim[1] - ylim[0]) / max(abs(xlim[1] - xlim[0]), 1e-30)
    fig_aspect = FIG_H / FIG_W
    H = box_aspect / fig_aspect
    if H <= 1.0:
        W = 1.0
    else:
        W, H = fig_aspect / box_aspect, 1.0
    return (1.0 - W) / 2 * FIG_W, (1.0 - H) / 2 * FIG_H, W * FIG_W, H * FIG_H


def _round_half_up(v: float) -> int:
    return int(math.floor(v + 0.5))


def verts_over_image_figure(verts2d: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """The reference's verts_vis figure of 2D vertices over an image
    (`predict/predict_3D.py:159-167`): what `plt.imshow(image)`,
    `plt.scatter(v[:, 0], v[:, 1], s=0.3)`, axes off, the axes over the
    whole figure and margins 0 save, as uint8 (480, 640, 4).

    The limits are the union of the image's extent and the vertices (y
    down, as imshow inverts it); the axes shrink to equal aspect, centred;
    the image is resampled to its box (rounded up to whole pixels) and the
    markers are drawn in 'C0' over it, both clipped to the axes.
    verts2d: (V, 2) pixel coordinates of the image; image: uint8 (H, W, 3),
    on one device.
    """
    dev = image.device
    H, W = image.shape[:2]
    v = verts2d.to(torch.float64)
    v = v[torch.isfinite(v).all(dim=1)]
    xmin, xmax, ymin, ymax = -0.5, W - 0.5, -0.5, H - 0.5
    if len(v):
        lo, hi = v.amin(dim=0).tolist(), v.amax(dim=0).tolist()
        xmin, xmax = min(xmin, lo[0]), max(xmax, hi[0])
        ymin, ymax = min(ymin, lo[1]), max(ymax, hi[1])
    xlim, ylim = (xmin, xmax), (ymax, ymin)                   # y inverted
    ax0, ay0, aw, ah = _equal_aspect_box(xlim, ylim)
    sx, sy = aw / (xlim[1] - xlim[0]), ah / (ylim[1] - ylim[0])

    def to_disp(x, y):
        return ax0 + (x - xlim[0]) * sx, ay0 + (y - ylim[0]) * sy

    # The image's extent in display pixels, clipped to the axes.
    ex0, ey0 = to_disp(-0.5, H - 0.5)
    ex1, ey1 = to_disp(W - 0.5, -0.5)
    cx0, cy0 = max(min(ex0, ex1), ax0), max(min(ey0, ey1), ay0)
    cx1, cy1 = min(max(ex0, ex1), ax0 + aw), min(max(ey0, ey1), ay0 + ah)
    canvas = torch.full((FIG_H, FIG_W, 4), 255, dtype=torch.uint8, device=dev)
    # Agg's clip box of the axes: corners rounded, the far ends inclusive.
    clip = (_round_half_up(ax0), _round_half_up(FIG_H - (ay0 + ah)),
            min(_round_half_up(ax0 + aw) + 1, FIG_W), min(_round_half_up(FIG_H - ay0) + 1, FIG_H))
    if cx1 > cx0 and cy1 > cy0:
        wb, hb = cx1 - cx0, cy1 - cy0
        if wb % 1.0 != 0.0 or hb % 1.0 != 0.0:
            ow, oh = math.ceil(wb), math.ceil(hb)
        else:
            ow, oh = int(wb), int(hb)
        stretch_x, stretch_y = ow / wb, oh / hb
        # Output buffer pixel centres -> display -> input pixel coordinates.
        j = torch.arange(ow, dtype=torch.float64, device=dev) + 0.5
        i = torch.arange(oh, dtype=torch.float64, device=dev) + 0.5        # bottom-up rows
        u = (cx0 + j / stretch_x - ax0) / sx + xlim[0] + 0.5
        vv = (cy0 + i / stretch_y - ay0) / sy + ylim[0] + 0.5
        scale_u, scale_v = 1.0 / (sx * stretch_x), 1.0 / (sy * stretch_y)
        disp_w, disp_h = abs(W * sx * stretch_x), abs(H * sy * stretch_y)
        nearest = ((disp_w > 3 * W or disp_w == W or disp_w == 2 * W)
                   and (disp_h > 3 * H or disp_h == H or disp_h == 2 * H))
        buf = agg_resample(image, u, vv, abs(scale_u), abs(scale_v), not nearest)
        buf = torch.flip(buf, dims=[0])                                  # top-down rows
        # The Agg wrapper rounds the image's corner to a pixel.
        col0, row0 = _round_half_up(cx0), int(FIG_H - (_round_half_up(cy0) + oh))
        r0, r1 = max(row0, clip[1]), min(row0 + oh, clip[3])
        c0, c1 = max(col0, clip[0]), min(col0 + ow, clip[2])
        if r1 > r0 and c1 > c0:
            canvas[r0:r1, c0:c1, :3] = buf[r0 - row0:r1 - row0, c0 - col0:c1 - col0]
    if len(v):
        xd, yd = to_disp(v[:, 0], v[:, 1])
        canvas = stamp_markers(canvas, xd, yd, (_MARKER_FILL_03, _MARKER_STROKE_03), C0, clip)
    return canvas


def verts_over_image_vis(verts2d: torch.Tensor, image: torch.Tensor, out_path: str) -> None:
    """Write `verts_over_image_figure` as a PNG."""
    write_png(out_path, verts_over_image_figure(verts2d, image).cpu().numpy())


# ---------------------------------------------------------------------------
# Agg's path stroker (agg_math_stroke.h / agg_vcgen_stroke.h) for the
# polylines the 3D figure draws: butt or square ('projecting') caps, miter
# or round joins, inner miter joins; open or closed.

def _cross(x1, y1, x2, y2, x, y):
    return (x - x2) * (y2 - y1) - (y - y2) * (x2 - x1)


def _intersection(ax, ay, bx, by, cx, cy, dx, dy):
    num = (ay - cy) * (dx - cx) - (ax - cx) * (dy - cy)
    den = (bx - ax) * (dy - cy) - (by - ay) * (dx - cx)
    if abs(den) < 1e-30:
        return None
    r = num / den
    return ax + r * (bx - ax), ay + r * (by - ay)


class _Stroker:
    """Agg's math_stroke with matplotlib's settings: half width `w`, the
    miter limit matplotlib passes (the line width in pixels), inner miter
    limit 1.01, approximation scale 1."""

    def __init__(self, width: float, cap: str, join: str, miter_limit: float):
        self.w = width / 2.0
        self.cap, self.join = cap, join
        self.miter_limit, self.inner_miter_limit = miter_limit, 1.01
        self.eps = self.w / 1024.0

    def calc_cap(self, out, v0, v1, length):
        dx1 = (v1[1] - v0[1]) / length * self.w
        dy1 = (v1[0] - v0[0]) / length * self.w
        dx2 = dy2 = 0.0
        if self.cap == "projecting":
            dx2, dy2 = dy1, dx1
        out.append((v0[0] - dx1 - dx2, v0[1] + dy1 - dy2))
        out.append((v0[0] + dx1 - dx2, v0[1] - dy1 - dy2))

    def calc_arc(self, out, x, y, dx1, dy1, dx2, dy2):
        a1 = math.atan2(dy1, dx1)
        a2 = math.atan2(dy2, dx2)
        da = math.acos(self.w / (self.w + 0.125)) * 2
        out.append((x + dx1, y + dy1))
        if a1 > a2:
            a2 += 2 * math.pi
        n = int((a2 - a1) / da)
        da = (a2 - a1) / (n + 1)
        a1 += da
        for _ in range(n):
            out.append((x + math.cos(a1) * self.w, y + math.sin(a1) * self.w))
            a1 += da
        out.append((x + dx2, y + dy2))

    def calc_miter(self, out, v0, v1, v2, dx1, dy1, dx2, dy2, mlimit):
        """A miter join, or a bevel where the miter is longer than `mlimit`
        half widths (Agg's miter_join_revert, which matplotlib's 'miter'
        joins and every inner join use)."""
        hit = _intersection(v0[0] + dx1, v0[1] - dy1, v1[0] + dx1, v1[1] - dy1,
                            v1[0] + dx2, v1[1] - dy2, v2[0] + dx2, v2[1] - dy2)
        if hit is not None:
            if math.hypot(v1[0] - hit[0], v1[1] - hit[1]) <= self.w * mlimit:
                out.append(hit)
                return
        else:
            x2, y2 = v1[0] + dx1, v1[1] - dy1
            if ((_cross(v0[0], v0[1], v1[0], v1[1], x2, y2) < 0.0)
                    == (_cross(v1[0], v1[1], v2[0], v2[1], x2, y2) < 0.0)):
                out.append((x2, y2))
                return
        out.append((v1[0] + dx1, v1[1] - dy1))
        out.append((v1[0] + dx2, v1[1] - dy2))

    def calc_join(self, out, v0, v1, v2, len1, len2):
        w = self.w
        dx1 = w * (v1[1] - v0[1]) / len1
        dy1 = w * (v1[0] - v0[0]) / len1
        dx2 = w * (v2[1] - v1[1]) / len2
        dy2 = w * (v2[0] - v1[0]) / len2
        cp = _cross(v0[0], v0[1], v1[0], v1[1], v2[0], v2[1])
        if cp > 1e-14:
            limit = max(min(len1, len2) / w, self.inner_miter_limit)
            self.calc_miter(out, v0, v1, v2, dx1, dy1, dx2, dy2, limit)
            return
        dbevel = math.hypot((dx1 + dx2) / 2, (dy1 + dy2) / 2)
        if self.join == "round" and w - dbevel < self.eps:
            hit = _intersection(v0[0] + dx1, v0[1] - dy1, v1[0] + dx1, v1[1] - dy1,
                                v1[0] + dx2, v1[1] - dy2, v2[0] + dx2, v2[1] - dy2)
            out.append(hit if hit is not None else (v1[0] + dx1, v1[1] - dy1))
            return
        if self.join == "round":
            self.calc_arc(out, v1[0], v1[1], dx1, -dy1, dx2, -dy2)
        else:
            self.calc_miter(out, v0, v1, v2, dx1, dy1, dx2, dy2, self.miter_limit)

    def outline(self, points, closed: bool):
        """The stroke's contours of a polyline (vcgen_stroke)."""
        pts = []
        for p in points:
            if not pts or math.hypot(p[0] - pts[-1][0], p[1] - pts[-1][1]) > 1e-14:
                pts.append((float(p[0]), float(p[1])))
        if closed and len(pts) > 2 and math.hypot(pts[0][0] - pts[-1][0],
                                                  pts[0][1] - pts[-1][1]) <= 1e-14:
            pts.pop()
        n = len(pts)
        if n < 2 or (closed and n < 3):
            return []
        dist = [math.hypot(pts[(i + 1) % n][0] - pts[i][0], pts[(i + 1) % n][1] - pts[i][1])
                for i in range(n)]
        if closed:
            first, second = [], []
            for i in range(n):
                self.calc_join(first, pts[i - 1], pts[i], pts[(i + 1) % n], dist[i - 1], dist[i])
            for i in range(n - 1, -1, -1):
                self.calc_join(second, pts[(i + 1) % n], pts[i], pts[i - 1], dist[i], dist[i - 1])
            return [first, second]
        out = []
        self.calc_cap(out, pts[0], pts[1], dist[0])
        for i in range(1, n - 1):
            self.calc_join(out, pts[i - 1], pts[i], pts[i + 1], dist[i - 1], dist[i])
        self.calc_cap(out, pts[n - 1], pts[n - 2], dist[n - 2])
        for i in range(n - 2, 0, -1):
            self.calc_join(out, pts[i + 1], pts[i], pts[i - 1], dist[i], dist[i - 1])
        return [out]


def _snap(points, linewidth_px: float):
    """matplotlib's PathSnapper in 'auto' mode: a path of only horizontal
    and vertical segments has its vertices moved to pixel centres (odd
    rounded line widths) or corners (even)."""
    pts = np.asarray(points, np.float64)
    if len(pts) > 1024:
        return pts
    d = np.abs(np.diff(pts, axis=0))
    if ((d[:, 0] >= 1e-4) & (d[:, 1] >= 1e-4)).any():
        return pts
    value = 0.5 if int(math.floor(linewidth_px + 0.5)) % 2 else 0.0
    return np.floor(pts + 0.5) + value


# ---------------------------------------------------------------------------
# Agg's scanline rasteriser: a pixel's coverage is the polygon's signed area
# inside it (vertices on a 1/256 pixel grid, nonzero winding), as 0-255.

def _g(t: torch.Tensor) -> torch.Tensor:
    """Integral of clamp(s, 0, 1) from 0 to t."""
    return 0.5 * t.clamp(0, 1).square() + (t - 1).clamp(min=0)


def polygon_area(edges: torch.Tensor, origin: torch.Tensor, size: Tuple[int, int]
                 ) -> torch.Tensor:
    """Signed area (float64) of P polygons in each pixel of P windows.

    edges: (P, E, 4) float64 segments (x0, y0, x1, y1) in pixels (x right,
    y down; pixel (r, c) covers [c, c + 1) x [r, r + 1)) of each polygon's
    closed contours, zero-length for padding.  origin: (P, 2) int64 (row,
    col) of each window's top-left pixel; size: its (rows, cols).  By
    Green's theorem a pixel's area is the sum over edges of the integral
    of clamp(x - col, 0, 1) dy over the edge's part in the pixel's row.
    Returns (P, rows, cols)."""
    q = torch.round(edges * _SUBPIXEL) / _SUBPIXEL
    rows, cols = size
    dev = edges.device
    r = origin[:, 0, None, None].to(torch.float64) + torch.arange(rows, device=dev,
                                                                  dtype=torch.float64)[None, None]
    x0, y0, x1, y1 = (q[..., k, None] for k in range(4))                  # (P, E, 1)
    ya = torch.clamp(y0, r, r + 1)                                        # (P, E, rows)
    yb = torch.clamp(y1, r, r + 1)
    dyl = y1 - y0
    safe = torch.where(dyl == 0, torch.ones_like(dyl), dyl)
    xa = x0 + (ya - y0) / safe * (x1 - x0)
    xb = x0 + (yb - y0) / safe * (x1 - x0)
    dy = yb - ya                                                          # (P, E, rows)
    c = (origin[:, 1, None, None, None].to(torch.float64)
         + torch.arange(cols, device=dev, dtype=torch.float64)[None, None, None])
    xa, xb, dy = xa[..., None], xb[..., None], dy[..., None]              # (P, E, rows, 1)
    dx = xb - xa
    flat = dx.abs() < 1e-12
    part = torch.where(flat, torch.clamp(xa - c, 0, 1),
                       (_g(xb - c) - _g(xa - c)) / torch.where(flat, torch.ones_like(dx), dx))
    return (dy * part).sum(dim=1)                                         # (P, rows, cols)


def _coverage(area: torch.Tensor) -> torch.Tensor:
    """Agg's coverage (0-255) of a signed area: it shifts its (negated)
    cell area right, the floor of -256 A, then takes the magnitude, so the
    rounding direction follows the winding."""
    return torch.clamp(torch.floor(-area * 256 + 1e-9).abs(), max=255).to(torch.int64)


def _contour_edges(contours, dev) -> torch.Tensor:
    segs = []
    for cnt in contours:
        p = np.asarray(cnt, np.float64)
        segs.append(np.concatenate([p, np.roll(p, -1, axis=0)], axis=1))
    return torch.as_tensor(np.concatenate(segs), device=dev)


def _mult_cover(a, cover):
    t = a * cover + 128
    return ((t >> 8) + t) >> 8


def _blend(canvas: torch.Tensor, r0: int, c0: int, cover: torch.Tensor, rgba) -> None:
    """Agg's plain RGBA blend of one colour over an opaque canvas window at
    (r0, c0) with per-pixel coverage, in place, clipped to the canvas."""
    H, W = canvas.shape[:2]
    rows, cols = cover.shape
    rr0, cc0 = max(r0, 0), max(c0, 0)
    rr1, cc1 = min(r0 + rows, H), min(c0 + cols, W)
    if rr1 <= rr0 or cc1 <= cc0:
        return
    a = _mult_cover(int(rgba[3]), cover[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0])[..., None]
    p = canvas[rr0:rr1, cc0:cc1, :3].to(torch.int64)
    col = torch.tensor(rgba[:3], dtype=torch.int64, device=canvas.device)
    out = torch.div((col * 256 - p * 255) * a + p * 255 * 256, a + 65280, rounding_mode="floor")
    canvas[rr0:rr1, cc0:cc1, :3] = torch.where(a > 0, out, p).to(torch.uint8)


def _fill_and_stroke(canvas, points, linewidth_px, cap, join, face=None, edge=None):
    """Draw one open path as RendererAgg::draw_path does: snapped, its fill
    in `face`, then its stroke in `edge` (8-bit RGBA tuples or None)."""
    pts = _snap(points, linewidth_px if edge is not None else 0.0)
    dev = canvas.device
    contours = []
    if face is not None:
        contours.append(([pts], face))
    if edge is not None and linewidth_px > 0:
        stroke = _Stroker(linewidth_px, cap, join, linewidth_px).outline(pts, closed=False)
        if stroke:
            contours.append((stroke, edge))
    for cnts, rgba in contours:
        allp = np.concatenate([np.asarray(c, np.float64) for c in cnts])
        lo = np.floor(allp.min(axis=0)).astype(np.int64) - 1
        hi = np.floor(allp.max(axis=0)).astype(np.int64) + 2
        origin = torch.tensor([[lo[1], lo[0]]], device=dev)
        cover = _coverage(polygon_area(_contour_edges(cnts, dev)[None], origin,
                                       (int(hi[1] - lo[1]), int(hi[0] - lo[0])))[0])
        _blend(canvas, int(lo[1]), int(lo[0]), cover, rgba)


def _rgba8(rgba) -> Tuple[int, int, int, int]:
    return tuple(int(v * 255 + 0.5) for v in rgba)


# ---------------------------------------------------------------------------
# The reference's 3D scatter (`ax.scatter(x, y, z, s=0.05)` on a 4 x 4 in
# figure at 100 dpi, view_init(elev=-90, azim=-90)): mplot3d 3.10's
# geometry, on the host in float64 with numpy's operation order.

SCATTER_WH = 400
_DPI = 100.0
_ELEV, _AZIM = -90.0, -90.0
_DIST, _FOCAL = 10.0, 1.0
_AX_BOX = (51.0, 44.0, 308.0, 308.0)     # the square axes: subplot (0.125, 0.11, 0.9, 0.88)
_VIEW_2D = (-0.95 / _DIST, 0.9 / _DIST)  # Axes3D.set_top_view
_PLANES = ((0, 3, 7, 4), (1, 2, 6, 5), (0, 1, 5, 4), (3, 2, 6, 7), (0, 1, 2, 3), (4, 5, 6, 7))
_JUGGLED = ((1, 0, 2), (0, 1, 2), (0, 2, 1))
_TICKDIR = (1, 0, 0)
_PANE_RGBA = ((0.95, 0.95, 0.95, 0.5), (0.9, 0.9, 0.9, 0.5), (0.925, 0.925, 0.925, 0.5))
_GRID_RGBA = (176 / 255, 176 / 255, 176 / 255, 1.0)   # '#b0b0b0'
_LINE_PX = 0.8 * _DPI / 72                               # axes, tick and grid line width
_PANE_PX = 1.0 * _DPI / 72
_SCATTER_LW_PX = 1.0 * _DPI / 72
_SCATTER_RADIUS_PX = 0.5 * math.sqrt(0.05) * _DPI / 72
_NBINS = 7                                # MaxNLocator 'auto': a 3.08 in axis / (3 x 10 pt)
_STEPS = np.array([0.1, 0.2, 0.25, 0.5, 1.0, 2.0, 2.5, 5.0, 10.0, 20.0])


def _box_aspect() -> np.ndarray:
    aspect = np.asarray((4, 4, 3), dtype=float)
    aspect *= 1.8294640721620434 * 25 / 24 * 1 / np.linalg.norm(aspect)
    return aspect


def _nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


def _axis_limits(lo: float, hi: float) -> Tuple[float, float]:
    """Axes3D.autoscale_view of one axis after a scatter: the locator's
    nonsingular range, 5% margins, then the 1/48 view margin."""
    x0, x1 = _nonsingular(lo, hi, expander=0.05)
    delta = (x1 - x0) * 0.05
    x0, x1 = x0 - delta, x1 + delta
    x0, x1 = _nonsingular(x0, x1, expander=1e-12, tiny=1e-13)
    lower, upper = sorted((x0, x1))
    delta = (upper - lower) * (1 / 48)
    return lower - delta, upper + delta


def _edge_le(x, step, offset):
    d, m = divmod(x, step)
    return d + 1 if _close(m / step, 1, step, offset) else d


def _edge_ge(x, step, offset):
    d, m = divmod(x, step)
    return d if _close(m / step, 0, step, offset) else d + 1


def _close(ms, edge, step, offset):
    if abs(offset) > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(abs(offset) / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def _major_ticks(vmin: float, vmax: float) -> np.ndarray:
    """AutoLocator's ticks of a 3D axis (MaxNLocator, 7 bins, steps 1, 2,
    2.5, 5, 10; its 3D 23/24 step), kept where they lie in the view."""
    lo, hi = _nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    dv = abs(hi - lo)
    meanv = (hi + lo) / 2
    if abs(meanv) / dv < 100:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / _NBINS) // 1)
    _vmin, _vmax = lo - offset, hi - offset
    steps = _STEPS * scale
    raw_step = (_vmax - _vmin) / _NBINS * 23 / 24
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        low = _edge_le(_vmin - best_vmin, step, offset)
        high = _edge_ge(_vmax - best_vmin, step, offset)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    locs = ticks + offset
    rtol = (vmax - vmin) * 1e-10
    return locs[(locs >= vmin - rtol) & (locs <= vmax + rtol)]


def _projection(lims) -> np.ndarray:
    """Axes3D.get_proj for the fixed view: world, view and perspective
    (focal length 1) matrices."""
    aspect = _box_aspect()
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = lims
    dx, dy, dz = (xmax - xmin) / aspect[0], (ymax - ymin) / aspect[1], (zmax - zmin) / aspect[2]
    worldM = np.array([[1 / dx, 0, 0, -xmin / dx], [0, 1 / dy, 0, -ymin / dy],
                       [0, 0, 1 / dz, -zmin / dz], [0, 0, 0, 1]])
    R = 0.5 * aspect
    elev, azim = np.deg2rad(_ELEV), np.deg2rad(_AZIM)
    ps = np.roll([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)], 0)
    eye = R + _DIST * ps
    V = np.zeros(3)
    V[2] = -1 if abs(elev) > np.pi / 2 else 1
    w = eye - R
    w = w / np.linalg.norm(w)
    u = np.cross(V, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    eye_focal = R + _DIST * ps * _FOCAL
    Mr, Mt = np.eye(4), np.eye(4)
    Mr[:3, :3] = [u, v, w]
    Mt[:3, -1] = -eye_focal
    viewM = np.dot(Mr, Mt)
    zf, zb = -_DIST, _DIST
    projM = np.array([[_FOCAL, 0, 0, 0], [0, _FOCAL, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)], [0, 0, -1, 0]])
    return np.dot(projM, np.dot(viewM, worldM))


def _proj(M, xs, ys, zs):
    vec = np.array([xs, ys, zs, np.ones_like(xs)], dtype=float)
    vecw = np.dot(M, vec)
    return vecw[0] / vecw[3], vecw[1] / vecw[3], vecw[2] / vecw[3]


def _to_canvas(px, py):
    """2D projected coordinates -> canvas pixels (x right, y down)."""
    lo, hi = _VIEW_2D
    x0, y0, w, h = _AX_BOX
    sx, sy = w / (hi - lo), h / (hi - lo)
    return x0 + (np.asarray(px) - lo) * sx, SCATTER_WH - (y0 + (np.asarray(py) - lo) * sy)


def _decorations(lims, M):
    """The panes, grid lines, axis lines and tick lines mplot3d draws, in
    order, as (points in canvas pixels, linewidth px, cap, join, face,
    edge) with 8-bit RGBA colours."""
    mins = np.array([lo for lo, _ in lims])
    maxs = np.array([hi for _, hi in lims])
    corners = [(mins[0], mins[1], mins[2]), (maxs[0], mins[1], mins[2]),
               (maxs[0], maxs[1], mins[2]), (mins[0], maxs[1], mins[2]),
               (mins[0], mins[1], maxs[2]), (maxs[0], mins[1], maxs[2]),
               (maxs[0], maxs[1], maxs[2]), (mins[0], maxs[1], maxs[2])]
    xs, ys, zs = zip(*corners)
    tc = np.column_stack(_proj(M, np.array(xs), np.array(ys), np.array(zs)))
    means_z0 = np.array([np.mean(tc[_PLANES[2 * i], 2]) for i in range(3)])
    means_z1 = np.array([np.mean(tc[_PLANES[2 * i + 1], 2]) for i in range(3)])
    highs = means_z0 < means_z1
    equals = np.abs(means_z0 - means_z1) <= np.finfo(float).eps
    if np.sum(equals) == 2:
        vertical = np.where(~equals)[0][0]
        if vertical == 2:
            highs = np.array([True, True, highs[2]])
        elif vertical == 1:
            highs = np.array([True, highs[1], False])
        else:
            highs = np.array([highs[0], False, False])
    minmax = np.where(highs, maxs, mins)
    maxmin = np.where(~highs, maxs, mins)
    deltas = (maxs - mins) * 0.08
    ticks = [_major_ticks(lo, hi) for lo, hi in lims]
    out = []
    for i in range(3):                                     # panes
        plane = _PLANES[2 * i + 1] if highs[i] else _PLANES[2 * i]
        pts = np.column_stack(_to_canvas(tc[list(plane), 0], tc[list(plane), 1]))
        rgba = _rgba8(_PANE_RGBA[i])
        out.append((pts, _PANE_PX, "butt", "miter", rgba, rgba))
    black = (0, 0, 0, 255)
    grid = _rgba8(_GRID_RGBA)
    for i in range(3):                                     # grid lines
        for loc in ticks[i]:
            xyz0 = minmax.copy()
            xyz0[i] = loc
            line = np.stack([xyz0, xyz0, xyz0])
            line[0, i - 2] = maxmin[i - 2]
            line[2, i - 1] = maxmin[i - 1]
            px, py, _ = _proj(M, line[:, 0], line[:, 1], line[:, 2])
            out.append((np.column_stack(_to_canvas(px, py)), _LINE_PX, "butt", "round",
                        None, grid))
    for i in range(3):                                     # axis line, then ticks
        juggled = _JUGGLED[i]
        edgep1 = minmax.copy()
        edgep1[juggled[0]] = maxmin[juggled[0]]
        edgep2 = edgep1.copy()
        edgep2[juggled[1]] = maxmin[juggled[1]]
        px, py, _ = _proj(M, np.array([edgep1[0], edgep2[0]]), np.array([edgep1[1], edgep2[1]]),
                          np.array([edgep1[2], edgep2[2]]))
        out.append((np.column_stack(_to_canvas(px, py)), _LINE_PX, "projecting", "round",
                    None, black))
        tickdir = _TICKDIR[i]
        tickdelta = deltas[tickdir] if highs[tickdir] else -deltas[tickdir]
        out_t = edgep1[tickdir] + 0.1 * tickdelta
        in_t = edgep1[tickdir] - 0.2 * tickdelta
        for loc in ticks[i]:
            pos = edgep1.copy()
            pos[i] = loc
            ends = []
            for t in (out_t, in_t):
                pos[tickdir] = t
                x, y, _ = _proj(M, np.array([pos[0]]), np.array([pos[1]]), np.array([pos[2]]))
                ends.append((x[0], y[0]))
            e = np.asarray(ends)
            out.append((np.column_stack(_to_canvas(e[:, 0], e[:, 1])), _LINE_PX, "projecting",
                        "round", None, black))
    return out


def _unit_circle_polygon() -> np.ndarray:
    """matplotlib's circle marker (8 cubic Beziers, radius 1) as Agg's
    curve4_div flattens it at marker sizes of a pixel or less: each curve
    is flat at the first test, so it adds the midpoint of its two control
    points after its start, a 16-gon."""
    k = 0.2652031
    s, t = math.sqrt(0.5), 0.8946336915882417
    q = 0.5195798707848535
    ctrl = np.array([[0, -1], [k, -1], [q, -t], [s, -s], [t, -q], [1, -k], [1, 0], [1, k],
                     [t, q], [s, s], [q, t], [k, 1], [0, 1], [-k, 1], [-q, t], [-s, s],
                     [-t, q], [-1, k], [-1, 0], [-1, -k], [-t, -q], [-s, -s], [-q, -t],
                     [-k, -1], [0, -1]], np.float64)
    pts = []
    for c in range(8):
        p0, p1, p2, p3 = ctrl[3 * c:3 * c + 4]
        pts += [p0, (p1 + p2) / 2]
    return np.asarray(pts)


def _scatter_marker_contours():
    """The 3D scatter's marker relative to its centre (canvas pixels, y
    down): the fill polygon and the stroke's two contours (width 1 pt,
    round joins)."""
    fill = _unit_circle_polygon() * _SCATTER_RADIUS_PX * np.array([1.0, -1.0])
    stroke = _Stroker(_SCATTER_LW_PX, "butt", "round", _SCATTER_LW_PX).outline(fill, closed=True)
    return [fill], stroke


_MARKER_GRID = 32
_MARKER_TABLES = {}


def _marker_area_table(device) -> torch.Tensor:
    """(2, G + 1, G + 1, 3, 3) signed areas of the 3D scatter marker's fill
    and stroke centred at (fx, fy), fx and fy on a grid of 1/G pixel in
    [0, 1], in the pixels of rows and columns -1..1: every marker is one of
    these shapes moved, so its areas interpolate bilinearly in the table
    (within about 1e-4 of a pixel)."""
    key = str(device)
    if key not in _MARKER_TABLES:
        g = torch.arange(_MARKER_GRID + 1, dtype=torch.float64, device=device) / _MARKER_GRID
        fy, fx = torch.meshgrid(g, g, indexing="ij")
        shift = torch.stack([fx, fy, fx, fy], dim=-1).reshape(-1, 1, 4)
        origin = torch.full((shift.shape[0], 2), -1, dtype=torch.int64, device=device)
        _MARKER_TABLES[key] = torch.stack([
            polygon_area(_contour_edges(contours, device)[None] + shift, origin, (3, 3))
            for contours in _scatter_marker_contours()]).view(
                2, _MARKER_GRID + 1, _MARKER_GRID + 1, 3, 3)
    return _MARKER_TABLES[key]


def scatter_figure(verts: torch.Tensor) -> torch.Tensor:
    """The reference's 3D scatter of predicted vertices
    (`predict/predict_3D.py:159-167`: `ax.scatter(v[:, 0], v[:, 1],
    v[:, 2], s=0.05)`, `view_init(elev=-90, azim=-90)`, 4 x 4 in at 100
    dpi) as uint8 (400, 400, 4), on the vertices' device.

    mplot3d's autoscaled limits and perspective projection, its panes,
    grid, axis and tick lines, and the markers in 'C0' sorted by depth with
    their depth-shaded alpha (1 at the front to 0.3 at the back), each
    rasterised and blended as Agg does.  The tick labels are not drawn (no
    font rasteriser)."""
    dev = verts.device
    v = verts.detach().to(torch.float64)
    host = v.cpu().numpy()
    lims = [_axis_limits(float(host[:, k].min()), float(host[:, k].max())) for k in range(3)]
    M = _projection(lims)
    canvas = torch.full((SCATTER_WH, SCATTER_WH, 4), 255, dtype=torch.uint8, device=dev)
    for pts, lw, cap, join, face, edge in _decorations(lims, M):
        _fill_and_stroke(canvas, pts, lw, cap, join, face, edge)
    Mt = torch.as_tensor(M, device=dev)
    vecw = torch.cat([v, torch.ones_like(v[:, :1])], dim=1) @ Mt.T
    px, py, pz = vecw[:, 0] / vecw[:, 3], vecw[:, 1] / vecw[:, 3], vecw[:, 2] / vecw[:, 3]
    keep = (px >= -1) & (px <= 1) & (py >= -1) & (py <= 1) & (pz <= 0)
    zmin, zmax = pz.min(), pz.max()
    sats = 1 - (pz - zmin) / torch.where(zmax > zmin, zmax - zmin, 1.0) * 0.7
    alpha = torch.floor(sats * 255 + 0.5).to(torch.int64)[keep]
    lo, hi = _VIEW_2D
    x0, y0, w, h = _AX_BOX
    cx = x0 + (px[keep] - lo) * (w / (hi - lo))
    cy = SCATTER_WH - (y0 + (py[keep] - lo) * (h / (hi - lo)))
    clip = (_round_half_up(x0), _round_half_up(SCATTER_WH - (y0 + h)),
            _round_half_up(x0 + w), _round_half_up(SCATTER_WH - y0))
    # Markers back to front (mplot3d's depth order), each filled then
    # stroked in its depth-shaded alpha, over the 3 x 3 pixels around it.
    rank = torch.empty_like(pz[keep], dtype=torch.int64)
    rank[torch.argsort(pz[keep], descending=True, stable=True)] = torch.arange(
        len(rank), device=dev)
    table = _marker_area_table(dev)
    base = torch.stack([torch.floor(cy), torch.floor(cx)], 1)
    f = (torch.stack([cy, cx], 1) - base) * _MARKER_GRID
    i = torch.clamp(torch.floor(f), max=_MARKER_GRID - 1).to(torch.int64)
    t = (f - i)[:, :, None, None]
    r0, c0 = i[:, 0], i[:, 1]
    rr = base[:, 0, None, None].to(torch.int64) + torch.arange(-1, 2, device=dev)[None, :, None]
    cc = base[:, 1, None, None].to(torch.int64) + torch.arange(-1, 2, device=dev)[None, None, :]
    inside = (rr >= clip[1]) & (rr < clip[3]) & (cc >= clip[0]) & (cc < clip[2])
    idx, order, alphas = [], [], []
    for phase in range(2):
        tab = table[phase]
        area = ((1 - t[:, 0]) * ((1 - t[:, 1]) * tab[r0, c0] + t[:, 1] * tab[r0, c0 + 1])
                + t[:, 0] * ((1 - t[:, 1]) * tab[r0 + 1, c0] + t[:, 1] * tab[r0 + 1, c0 + 1]))
        a = _mult_cover(alpha[:, None, None], _coverage(area))
        drawn = inside & (a > 0)
        idx.append((rr * SCATTER_WH + cc)[drawn])
        order.append((rank * 2 + phase)[:, None, None].expand_as(a)[drawn])
        alphas.append(a[drawn])
    return blend_sequence(canvas, torch.cat(idx), torch.cat(order), torch.cat(alphas), C0)


def scatter_vis(verts: torch.Tensor, out_path: str) -> None:
    """Write `scatter_figure` as a PNG."""
    write_png(out_path, scatter_figure(verts).cpu().numpy())
