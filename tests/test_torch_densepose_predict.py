"""The DensePose route of the image front end in the PyTorch port: cv2's
INTER_NEAREST resize, matplotlib's viridis, the DensePose overlay, and
`predict_3d` from PNG images through Keypoint-RCNN R50-FPN +
DensePose-RCNN R101-FPN, against cv2, matplotlib and the JAX package.

The resize, the colormap and the overlay are held bit for bit.
The whole slice runs both packages on the same PNGs, detectron2 pickles
and regressor checkpoint at a 64² frame and a 96² detector size (the JAX
package's sizes patched in this test only), 64 proposals and 4
detections, as `tests/test_torch_detect.py` runs the PointRend route: the
cached silhouettes equal on 99% of pixels, joints within 0.1 px where the
keypoint argmax agrees, npy outputs within 1e-3 of each array's largest
value, renders with fewer than 0.2% of pixels moved by more than one
level, the DensePose overlays with fewer than 1%.
"""

import os

import cv2
import matplotlib
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

import straps_tpu.perception as JPERC
from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.predict import pipeline as JP
from straps_tpu.render import vis as JV
from straps_tpu_torch.cli import run_predict
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.perception import rcnn as TR
from straps_tpu_torch.perception.convert_d2 import save_d2_pkl
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.render import vis as TV
from straps_tpu_torch.utils.image import cv2_resize_nearest
from test_torch_detect import FRAME, IMG, NPY_KEYS, SEED, TEST_SIZE, _files, slice_inputs  # noqa: F401
from test_torch_perception import person_biased
from torch_figures import assert_within_bounds, read_rgba, verts_vis_base
from torch_margins import assert_nms_margins, record_nms
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# -------------------------------------------------------- resize, vis --

@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_cv2_resize_nearest_matches_cv2(dtype):
    """Up- and downscales, integer and non-integer ratios, 1-pixel sides."""
    rng = np.random.RandomState(0)
    for hw, out in (((56, 56), (97, 113)), ((56, 56), (13, 29)), ((37, 53), (300, 211)),
                    ((64, 64), (128, 32)), ((3, 7), (1, 1)), ((100, 1), (7, 255)),
                    ((256, 256), (512, 512))):
        img = (rng.rand(*hw) * 1000).astype(dtype)
        want = cv2.resize(img, out, interpolation=cv2.INTER_NEAREST)
        got = cv2_resize_nearest(torch.as_tensor(img), *out).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{hw} -> {out}")


@pytest.mark.parametrize("case", ["labels", "image_range", "narrow_range"])
def test_apply_colormap_matches_matplotlib(case):
    """The part labels clipped to [0, 24] (the overlay's use), a float
    image between its own extremes, and a float image clipped to a range
    inside them; the labels against the JAX function too."""
    cmap = matplotlib.colormaps["viridis"]
    x = np.random.RandomState(1).randn(40, 50) * 3
    if case == "labels":
        x, lo, hi = np.arange(-2, 30).reshape(4, 8), 0, 24
        np.testing.assert_array_equal(TV.apply_colormap(torch.as_tensor(x), lo, hi).numpy(),
                                      JV.apply_colormap(x, vmin=lo, vmax=hi))
    else:
        lo, hi = (x.min(), x.max()) if case == "image_range" else (-1.5, 2.25)
    np.testing.assert_array_equal(TV.apply_colormap(torch.as_tensor(x), lo, hi).numpy(),
                                  cmap((np.clip(x, lo, hi) - lo) / (hi - lo), bytes=True))


def test_densepose_overlay_and_roi_paste_match_jax_and_cv2():
    """`densepose_overlay_vis` is `cv2.addWeighted(img, 0.6, vis, 0.4, 0)`
    bit for bit: every pair of levels, and the JAX overlay on part labels
    pasted into boxes by the JAX nearest paste."""
    levels = np.arange(256, dtype=np.uint8)
    a = np.repeat(np.repeat(levels[:, None], 256, 1)[..., None], 3, -1)
    b = np.ascontiguousarray(a.transpose(1, 0, 2))
    blend = torch.round(torch.as_tensor(a).float() * 0.6 + torch.as_tensor(b).float() * 0.4
                        + 0.0).to(torch.uint8).numpy()
    np.testing.assert_array_equal(blend, cv2.addWeighted(a, 0.6, b, 0.4, 0))
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (2, 48, 40, 3)).astype(np.uint8)
    roi = rng.randint(0, 25, (56, 56)).astype(np.uint8)
    boxes = [[4.5, 6.0, 20.5, 22.4], [-3.0, 10.2, 45.7, 60.0]]
    labels = np.stack([JV.paste_roi_map(roi, np.asarray(box), 48, 40) for box in boxes])
    got = TV.densepose_overlay_vis(torch.as_tensor(img), torch.as_tensor(labels)).numpy()
    for k in range(2):
        np.testing.assert_array_equal(got[k], JV.densepose_overlay_vis(img[k], labels[k]))
    assert (got[0] != img[0]).any()


# -------------------------------------------------------- whole slice --

def densepose_biased(state, fg_bias=1.5):
    """`person_biased` plus the coarse segmentation's foreground channels
    raised, so that the detections are mostly foreground."""
    out = person_biased(state)
    b = out["roi_heads.densepose_predictor.ann_index_lowres.bias"].clone()
    b[1:] += fg_bias
    out["roi_heads.densepose_predictor.ann_index_lowres.bias"] = b
    return out


@pytest.fixture(scope="module")
def densepose_pkl(slice_inputs, tmp_path_factory):  # noqa: F811
    path = str(tmp_path_factory.mktemp("dp") / "dp.pkl")
    model = TR.init_random_weights(TR.DensePoseRCNN(), torch.Generator().manual_seed(2 * SEED + 1))
    save_d2_pkl(path, densepose_biased(model.state_dict()))
    return path


def _cfg(cls, images, kp_pkl, dp_pkl, ckpt, out_dir):
    cfg = cls(input_dir=images, checkpoint=ckpt, out_dir=out_dir, silhouettes_from="densepose",
              keypoint_checkpoint=kp_pkl, silhouette_checkpoint=dp_pkl, img_wh=IMG,
              detector_post_nms_topk=64, detector_max_detections=4)
    cfg.model.compute_dtype = None
    if cls is PredictConfig:
        cfg.detector_image_size, cfg.detector_test_size = FRAME, TEST_SIZE
    return cfg


def test_predict_3d_densepose_from_images_vs_jax(slice_inputs, densepose_pkl,  # noqa: F811
                                                 tmp_path, monkeypatch):
    images, pkls, ckpt = slice_inputs
    calls = record_nms(monkeypatch)
    got = TP.predict_3d(_cfg(PredictConfig, images, pkls[0], densepose_pkl, ckpt,
                             str(tmp_path / "torch")), device="cpu")
    assert_nms_margins(calls)
    for boxes, scores, thr, n, idx, valid in calls:
        if thr == 0.5:
            assert ((scores[torch.isfinite(scores)] - 0.05) > 1e-4).all()

    monkeypatch.setattr(JPERC, "DEFAULT_IMAGE_SIZE", FRAME)
    monkeypatch.setattr(JPERC, "DETECTOR_TEST_SIZE", TEST_SIZE)
    want = JP.predict_3d(_cfg(JaxPredictConfig, images, pkls[0], densepose_pkl, ckpt,
                              str(tmp_path / "jax")))
    assert got["names"] == want["names"] == ["im0", "im1", "im2"]
    sil_agree, joints_close = [], []
    for name in got["names"]:
        sil = [np.load(tmp_path / side / "proxies" / f"{name}_silhouette.npy")
               for side in ("torch", "jax")]
        joints = [np.load(tmp_path / side / "proxies" / f"{name}_joints2D.npy")
                  for side in ("torch", "jax")]
        assert sil[0].shape == (FRAME, FRAME) and joints[0].shape == (17, 2)
        sil_agree.append((sil[0] == sil[1]).mean())
        joints_close.append((np.abs(joints[0] - joints[1]).max(-1) < 0.1).mean())
        assert sil[0].sum() > 0
    assert min(sil_agree) > 0.99 and min(joints_close) > 0.8
    for k in NPY_KEYS:
        assert np.abs(got[k] - want[k]).max() <= 1e-3 * np.abs(want[k]).max(), k
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    frames = TP.read_images(images, FRAME, "cpu")[1].numpy()
    for i, name in enumerate(got["names"]):
        sil = np.load(tmp_path / "jax" / "proxies" / f"{name}_silhouette.npy")
        base = verts_vis_base(want["verts"][i], want["cam_wp"][i], sil, frames[i],
                              TP.crop_image_like_proxy)
        assert_within_bounds(
            read_rgba(str(tmp_path / "torch" / "verts_vis" / f"verts_{name}.png")),
            read_rgba(str(tmp_path / "jax" / "verts_vis" / f"verts_{name}.png")), base)
    for name in got["names"]:
        for kind in ("rend", "reposed"):
            img = mpimg.imread(str(tmp_path / "torch" / "rend_vis" / f"{kind}_{name}.png"))
            ref = mpimg.imread(str(tmp_path / "jax" / "rend_vis" / f"{kind}_{name}.png"))
            moved = (np.abs(img - ref[..., :3]) > 1.5 / 255).any(axis=-1).mean()
            assert moved < 0.002, (kind, name, moved)
        img = mpimg.imread(str(tmp_path / "torch" / "proxy_vis" / f"silhouette_{name}.png"))
        ref = mpimg.imread(str(tmp_path / "jax" / "proxy_vis" / f"silhouette_{name}.png"))
        assert (np.abs(img - ref[..., :3]) > 1.5 / 255).any(axis=-1).mean() < 0.01


def test_cli_runs_the_densepose_path(slice_inputs, densepose_pkl, tmp_path, capsys):  # noqa: F811
    images, pkls, ckpt = slice_inputs
    out = str(tmp_path / "out")
    got = run_predict.main(["--input", images, "--silh-from", "densepose", "--checkpoint", ckpt,
                            "--keypoint-checkpoint", pkls[0], "--silhouette-checkpoint",
                            densepose_pkl, "--out-dir", out, "--device", "cpu", f"img_wh={IMG}",
                            "detector_post_nms_topk=32", "detector_max_detections=2",
                            f"detector_image_size={FRAME}", f"detector_test_size={TEST_SIZE}"])
    assert "predicted 3 images" in capsys.readouterr().out
    assert all(np.isfinite(got[k]).all() for k in NPY_KEYS)
    names = ("im0", "im1", "im2")
    assert sorted(os.listdir(os.path.join(out, "proxy_vis"))) == sorted(
        f"{k}_{n}.png" for k in ("silhouette", "joints2D") for n in names)
    assert len(os.listdir(os.path.join(out, "rend_vis"))) == 6
    assert len(os.listdir(os.path.join(out, "proxies"))) == 6
