"""The predict path's vis without cv2 or matplotlib (`render/vis.py`'s
keypoint overlay with its joint-index text, `render/figures.py`'s
`verts_over_image_vis` and `scatter_vis`) against the JAX package's
functions.

`keypoints_vis` is held bit for bit, text included.  The two matplotlib
figures are held to `torch_figures.BOUNDS` (away from the markers at most
8 levels and 1 level on mean; at least 95% of the marker pixels within 8
levels), with the tick labels of the 3D scatter left out.  Measured here
(matplotlib 3.10.8): away from the markers at most 1 level for
`verts_over_image_vis` and 3 for `scatter_vis` (means below 0.002), and
100% of the marker pixels within 8 levels; the tick labels' boxes cover
3.6-5.2% of the scatter's pixels.
"""

import numpy as np
import pytest
import torch

from straps_tpu.render import vis as JV
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.render import figures as TFIG
from straps_tpu_torch.render import vis as TV
from straps_tpu_torch.utils.png import decode_png
from torch_figures import (
    assert_within_bounds, mpl_scatter, mpl_verts_over_image, read_rgba, text_mask,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _keypoints(case, rng, B, H, W):
    J = 17
    if case == "random":
        xy = np.stack([rng.uniform(0, W, (B, J)), rng.uniform(0, H, (B, J))], -1)
    elif case == "edges":
        side = rng.integers(0, 4, (B, J))
        t = rng.uniform(0, 1, (B, J))
        d = rng.uniform(-12, 12, (B, J))
        x = np.select([side == 0, side == 1], [d, W - 1 + d], t * W)
        y = np.select([side == 2, side == 3], [d, H - 1 + d], t * H)
        xy = np.stack([x, y], -1)
    elif case == "outside":
        xy = np.stack([rng.uniform(-30, W + 30, (B, J)), rng.uniform(-30, H + 30, (B, J))], -1)
    else:                                            # overlapping: the order decides
        xy = rng.uniform(20, 40, (B, 1, 2)) + rng.normal(0, 3, (B, J, 2))
    xy[0, 0] = (10.5, 12.5)                          # halves round to even
    return np.concatenate([xy, rng.random((B, J, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "edges", "outside", "overlap"])
def test_keypoints_vis_with_text_equals_jax(case):
    rng = np.random.default_rng(["random", "edges", "outside", "overlap"].index(case))
    B, H, W = 3, 61, 77
    img = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    kp = _keypoints(case, rng, B, H, W)
    got = TV.keypoints_vis(torch.as_tensor(img), torch.as_tensor(kp)).numpy()
    for i in range(B):
        want = JV.keypoints_vis(img[i], kp[i])
        np.testing.assert_array_equal(got[i], want)
    assert ((got[..., 0] > 200) & (got[..., 1] < 80)).any()          # red text drawn


def test_keypoints_vis_refuses_more_joints_than_labels():
    with pytest.raises(ValueError, match="at most 17"):
        TV.keypoints_vis(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), torch.zeros(1, 18, 2))


def _crop(rng, n=512):
    """A smooth image with hard edges, like a resized photo crop."""
    small = rng.integers(0, 256, (24, 24, 3)).astype(np.float64)
    img = np.kron(small, np.ones((n // 24 + 1, n // 24 + 1, 1)))[:n, :n]
    img[100:140, 50:400] = rng.integers(0, 256, 3)
    img[::37] = 0
    return img.astype(np.uint8)


VERTS_CASES = {
    "inside": lambda rng: rng.uniform(60, 450, (3000, 2)),
    "vertex_outside": lambda rng: np.concatenate([rng.uniform(60, 450, (3000, 2)),
                                                  [[-100.0, 700.0]]]),
    "far_corner": lambda rng: np.concatenate([rng.uniform(60, 450, (500, 2)), [[900.0, -300.0]]]),
    "wide": lambda rng: np.concatenate([rng.uniform(0, 500, (500, 2)), [[-400.0, 200.0]]]),
}


@pytest.mark.parametrize("case", sorted(VERTS_CASES))
def test_verts_over_image_vis_within_bounds(case, tmp_path):
    rng = np.random.default_rng(sorted(VERTS_CASES).index(case))
    verts2d, img = VERTS_CASES[case](rng), _crop(rng)
    JV.verts_over_image_vis(verts2d, img, str(tmp_path / "jax.png"))
    want = read_rgba(str(tmp_path / "jax.png"))
    TFIG.verts_over_image_vis(torch.as_tensor(verts2d), torch.as_tensor(img),
                              str(tmp_path / "port.png"))
    got = read_rgba(str(tmp_path / "port.png"))
    base = mpl_verts_over_image(verts2d, img, markers=False)
    assert got.shape == want.shape == (480, 640, 4) and (got[..., 3] == 255).all()
    m = assert_within_bounds(got, want, base)
    # The white background is exact away from the markers, and the image's
    # box (its pixels over a black crop) spans the same rows and columns.
    changed = (np.abs(got - base)[..., :3].max(-1) > 0) | (np.abs(want - base)[..., :3].max(-1) > 0)
    white = (base[..., :3] == 255).all(-1) & ~changed
    assert white.any() and (got[white] == 255).all()
    black = np.zeros_like(img)
    port_box = (TFIG.verts_over_image_figure(torch.as_tensor(verts2d), torch.as_tensor(black))
                .numpy()[..., :3] == 0).all(-1)
    ref_box = (mpl_verts_over_image(verts2d, black, markers=False)[..., :3] == 0).all(-1)
    extent = [(np.nonzero(b.any(1))[0][[0, -1]], np.nonzero(b.any(0))[0][[0, -1]])
              for b in (port_box, ref_box)]
    np.testing.assert_array_equal(np.concatenate(extent[0]), np.concatenate(extent[1]))
    if case == "inside":
        assert tuple(extent[1][1]) == (80, 559)
    assert m["marker_pixels"] > 0


def test_verts_over_image_box_with_a_vertex_outside_the_crop():
    """One vertex at (-100, 700) widens the limits: the image spans columns
    179-529 and rows 0-350, as matplotlib draws it."""
    img = torch.zeros(512, 512, 3, dtype=torch.uint8)
    fig = TFIG.verts_over_image_figure(torch.tensor([[-100.0, 700.0]]), img).numpy()
    ref = mpl_verts_over_image(np.array([[-100.0, 700.0]]), img.numpy(), markers=False)
    box = (fig[..., :3] == 0).all(-1)
    np.testing.assert_array_equal(box, (ref[..., :3] == 0).all(-1))
    rows, cols = np.nonzero(box)
    assert (rows.min(), rows.max(), cols.min(), cols.max()) == (0, 350, 179, 529)


def _template():
    return np.asarray(load_synthetic_assets().v_template, np.float64)


SCATTER_CASES = {
    "template": lambda rng: _template(),
    "template_turned": lambda rng: _template()[:, [0, 2, 1]] * [1, -1, 1] + [0.05, 0.1, 2.5],
    "cloud": lambda rng: rng.normal(0, 1, (2000, 3)) * [0.3, 0.8, 0.2] + [0.1, -0.2, 3],
    "plane": lambda rng: np.c_[rng.uniform(-1, 1, (800, 2)), np.zeros(800)],
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_vis_within_bounds(case, tmp_path):
    rng = np.random.default_rng(sorted(SCATTER_CASES).index(case))
    verts = SCATTER_CASES[case](rng)
    JV.scatter_vis(verts, str(tmp_path / "jax.png"))
    want = read_rgba(str(tmp_path / "jax.png"))
    TFIG.scatter_vis(torch.as_tensor(verts), str(tmp_path / "port.png"))
    got = read_rgba(str(tmp_path / "port.png"))
    base, boxes = mpl_scatter(verts, markers=False)
    labels = text_mask(boxes, got.shape[:2])
    assert got.shape == want.shape == (400, 400, 4) and (got[..., 3] == 255).all()
    assert 0.02 < labels.mean() < 0.07
    assert_within_bounds(got, want, base, labels)


def test_figures_are_pngs_the_port_reads(tmp_path):
    verts = torch.as_tensor(_template())
    TFIG.scatter_vis(verts, str(tmp_path / "s.png"))
    assert decode_png(str(tmp_path / "s.png")).shape == (400, 400, 3)
    TV.verts_over_image_vis(verts[:, :2] * 200 + 256, torch.zeros(512, 512, 3, dtype=torch.uint8),
                            str(tmp_path / "v.png"))
    assert decode_png(str(tmp_path / "v.png")).shape == (480, 640, 3)
