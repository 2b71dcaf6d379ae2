"""Helpers of the port's tests of matplotlib's figures (`verts_vis/`): the
same figures drawn by matplotlib, with or without their markers, the
tick labels' boxes, and the bounds a port figure is held to.

Bounds, against matplotlib's figure of the same call (`want`) and the
same figure with its scatter invisible (`base`, same limits):
* the pixels neither figure's markers change (by more than 8 levels from
  `base`) are within 8 levels of `want` everywhere and 1 level on mean;
* the pixels either figure's markers change are within 8 levels of
  `want` on at least 95% of them;
pixels inside the tick labels' boxes, widened by 2 px, are left out (the
port draws no text).
"""

import io

import matplotlib

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

BOUNDS = {"away_max": 8, "away_mean": 1.0, "marker_agree": 0.95}
CHANGED = 8


def _png(fig) -> np.ndarray:
    buf = io.BytesIO()
    fig.savefig(buf)
    plt.close(fig)
    buf.seek(0)
    return read_rgba(buf)


def read_rgba(path_or_file) -> np.ndarray:
    """A PNG as uint8 RGBA (int64)."""
    a = mpimg.imread(path_or_file)
    if a.shape[-1] == 3:
        a = np.concatenate([a, np.ones(a.shape[:2] + (1,), a.dtype)], -1)
    return np.round(a * 255).astype(np.int64)


def mpl_verts_over_image(verts2d, image, markers=True) -> np.ndarray:
    """`straps_tpu.render.vis.verts_over_image_vis`'s figure, its scatter
    hidden unless `markers`."""
    v = np.asarray(verts2d)
    fig = plt.figure()
    plt.imshow(np.asarray(image, np.uint8))
    plt.scatter(v[:, 0], v[:, 1], s=0.3).set_visible(markers)
    plt.gca().set_axis_off()
    plt.subplots_adjust(top=1, bottom=0, right=1, left=0, hspace=0, wspace=0)
    plt.margins(0, 0)
    plt.gca().xaxis.set_major_locator(plt.NullLocator())
    plt.gca().yaxis.set_major_locator(plt.NullLocator())
    return _png(fig)


def mpl_scatter(verts, markers=True):
    """`straps_tpu.render.vis.scatter_vis`'s figure, its scatter hidden
    unless `markers`, and its tick labels' boxes (x, y, w, h) in display
    pixels."""
    v = np.asarray(verts)
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(v[:, 0], v[:, 1], v[:, 2], s=0.05).set_visible(markers)
    ax.view_init(elev=-90, azim=-90)
    buf = io.BytesIO()
    fig.savefig(buf, dpi=100)
    renderer = fig.canvas.get_renderer()
    boxes = [t.label1.get_window_extent(renderer).bounds
             for axis in (ax.xaxis, ax.yaxis, ax.zaxis) for t in axis.get_major_ticks()
             if t.label1.get_visible() and t.label1.get_text()]
    plt.close(fig)
    buf.seek(0)
    return read_rgba(buf), boxes


def text_mask(boxes, shape, pad=2) -> np.ndarray:
    """Pixels inside the boxes (display coordinates, y up), widened."""
    H, W = shape
    m = np.zeros((H, W), bool)
    for x, y, w, h in boxes:
        c0, c1 = int(np.floor(x - pad)), int(np.ceil(x + w + pad))
        r0, r1 = int(np.floor(H - (y + h) - pad)), int(np.ceil(H - y + pad))
        m[max(r0, 0):max(r1, 0), max(c0, 0):max(c1, 0)] = True
    return m


def figure_agreement(got, want, base, exclude=None) -> dict:
    """The measures `BOUNDS` limits, for uint8 RGBA figures."""
    got, want, base = (np.asarray(a, np.int64)[..., :3] for a in (got, want, base))
    exclude = np.zeros(got.shape[:2], bool) if exclude is None else exclude
    d = np.abs(got - want).max(-1)
    markers = ((np.abs(want - base).max(-1) > CHANGED)
               | (np.abs(got - base).max(-1) > CHANGED)) & ~exclude
    away = ~markers & ~exclude
    return {"away_max": int(d[away].max()), "away_mean": float(d[away].mean()),
            "marker_agree": float((d[markers] <= CHANGED).mean()) if markers.any() else 1.0,
            "marker_pixels": int(markers.sum())}


def assert_within_bounds(got, want, base, exclude=None) -> dict:
    m = figure_agreement(got, want, base, exclude)
    assert m["away_max"] <= BOUNDS["away_max"], m
    assert m["away_mean"] <= BOUNDS["away_mean"], m
    assert m["marker_agree"] >= BOUNDS["marker_agree"], m
    return m


def verts_vis_base(verts, cam_wp, sil, frame_image, crop_fn):
    """The image-only figure of a JAX predict's verts_vis: the vertices
    projected as `straps_tpu/predict/pipeline.py` projects them (512
    frame), over its crop of the frame image (`crop_fn`, the proxy's
    silhouette crop) resized to 512 x 512 with cv2, scatter hidden."""
    import cv2
    v = np.asarray(verts, np.float32)
    cam = np.asarray(cam_wp, np.float32)
    verts2d = (cam[0] * (v[:, :2] + cam[1:3]) + 1.0) * (512 / 2.0)
    crop = cv2.resize(crop_fn(sil, frame_image), (512, 512), interpolation=cv2.INTER_LINEAR)
    return mpl_verts_over_image(verts2d, crop, markers=False)
