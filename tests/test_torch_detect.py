"""The image slice of the PyTorch port: PNG decoding, the three resizes,
the detector overlays, and `predict_3d` from PNG images through
Keypoint-RCNN + PointRend, against cv2, Pillow and the JAX package.

The decoder and the uint8 resizes are held bit for bit (cv2.imread,
cv2.resize INTER_LINEAR with its exact-2x INTER_AREA route, Pillow's
bilinear); the float cv2 resize to one level after the uint8 conversion.
The whole slice runs both packages on the same PNGs, detectron2 pickles
and regressor checkpoint at a 64² frame and a 96² detector size (the JAX
package's sizes patched in this test only), 64 proposals and 4
detections: the cached silhouettes equal on 99% of pixels, joints within
0.1 px where the keypoint argmax agrees, npy outputs within 1e-3 of each
array's largest value, renders with fewer than 0.2% of pixels moved by more
than one level.
"""

import glob
import os

import cv2
import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch
from PIL import Image

import straps_tpu.perception as JPERC
from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.models import build_regressor
from straps_tpu.predict import pipeline as JP
from straps_tpu.render import vis as JV
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.cli import run_predict
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, state_dict_to_tensors
from straps_tpu_torch.perception import frontend as TF
from straps_tpu_torch.perception import rcnn as TR
from straps_tpu_torch.perception.convert_d2 import save_d2_pkl
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.render import vis as TV
from straps_tpu_torch.utils.image import cv2_resize_linear_f32, cv2_resize_linear_u8
from straps_tpu_torch.utils.png import decode_png, write_png
from test_torch_perception import person_biased
from torch_figures import assert_within_bounds, read_rgba, verts_vis_base
from torch_margins import assert_nms_margins, record_nms
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FRAME, TEST_SIZE, IMG = 64, 96, 64
# The images' and detectors' seed: at seed 0 an RPN IoU that decides a
# proposal lies within 1e-4 of 0.7 (`assert_nms_margins`).
SEED = 1
NPY_KEYS = ("verts", "shape", "pose_rotmats", "cam_wp")


# --------------------------------------------------------- image input --

@pytest.mark.parametrize("writer,channels", [("cv2", 1), ("cv2", 3), ("cv2", 4), ("pillow", 1),
                                             ("pillow", 2), ("pillow", 3), ("pillow", 4)])
def test_decode_png_matches_cv2_imread(tmp_path, channels, writer):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (23, 37, channels)).astype(np.uint8)
    img[4:15, 6:30] = 200                       # flat regions: every filter is chosen
    img[:, ::3] //= 2
    path = str(tmp_path / "x.png")
    if writer == "cv2":
        order = {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[channels]
        cv2.imwrite(path, img[..., order])
    else:
        mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
        Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(path, optimize=True)
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(decode_png(path), want)


@pytest.mark.parametrize("hw", [(640, 640), (1024, 1024), (400, 400), (512, 384)])
def test_cv2_resize_linear_u8_is_bit_exact(hw):
    """640² and 400² (a 300x400 image padded) take the linear path, 1024²
    the exact-2x INTER_AREA route."""
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    img[100:300, 50:250] = rng.randint(0, 256, 3)
    want = cv2.resize(img, (512, 512), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(cv2_resize_linear_u8(torch.as_tensor(img), 512, 512).numpy(),
                                  want)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw,out", [((37, 53), (29, 20)), ((480, 640), (517, 333)),
                                    ((7, 101), (3, 5)), ((452, 600), (500, 500))])
def test_cv2_resize_linear_u8_rows_with_a_tail(hw, out, channels):
    """Destination rows whose bytes are not a multiple of 16, and rows
    shorter than 16 bytes (5x3, 1 and 3 channels): every pixel equals
    cv2's.  `out` is (out_w, out_h), as cv2.resize takes it."""
    rng = np.random.RandomState(hw[1] + channels)
    img = rng.randint(0, 256, hw + (channels,)).astype(np.uint8)
    want = cv2.resize(img, out, interpolation=cv2.INTER_LINEAR).reshape(out[1], out[0], channels)
    np.testing.assert_array_equal(cv2_resize_linear_u8(torch.as_tensor(img), *out).numpy(), want)


def test_cv2_resize_linear_u8_random_sizes():
    """100 seeded resizes, sources of 2-79 px a side to outputs of 1-89,
    1, 3 or 4 channels, up and down: every pixel equals cv2's."""
    rng = np.random.RandomState(11)
    for i in range(100):
        h, w = rng.randint(2, 80, 2)
        out = tuple(int(v) for v in rng.randint(1, 90, 2))
        c = (1, 3, 4)[i % 3]
        img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        want = cv2.resize(img, out, interpolation=cv2.INTER_LINEAR).reshape(out[1], out[0], c)
        np.testing.assert_array_equal(cv2_resize_linear_u8(torch.as_tensor(img), *out).numpy(),
                                      want, err_msg=f"{w}x{h}x{c} -> {out}")


@pytest.mark.parametrize("hw,out", [((37, 53), (64, 64)), ((90, 70), (64, 64)),
                                    ((128, 128), (64, 64))])
def test_cv2_resize_linear_f32_matches_cv2(hw, out):
    img = np.random.RandomState(0).rand(*hw, 3).astype(np.float32)
    want = cv2.resize(img, out, interpolation=cv2.INTER_LINEAR)
    got = cv2_resize_linear_f32(torch.as_tensor(img), *out).numpy()
    np.testing.assert_allclose(got, want, atol=3e-7)
    assert (np.floor(got * 255) != np.floor(want * 255)).mean() < 1e-3


@pytest.mark.parametrize("hw,out", [((512, 512), 800), ((64, 64), 96), ((900, 700), 800)])
def test_pil_bilinear_resize_is_bit_exact(hw, out):
    img = np.random.RandomState(1).randint(0, 256, hw + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out, out), Image.BILINEAR))
    got = TF.pil_bilinear_resize_u8(torch.as_tensor(img)[None], out, out)[0].numpy()
    np.testing.assert_array_equal(got, want)
    f = img.astype(np.float32)
    np.testing.assert_allclose(TF.bilinear_resize_f32(torch.as_tensor(f), out, out).numpy(),
                               JPERC.frontend.bilinear_resize_f32(f, out, out), atol=1e-3)


# ------------------------------------------------------------ overlays --

def test_overlays_match_jax_vis():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sil = (rng.rand(2, 64, 64) > 0.6).astype(np.float32)
    kp = np.concatenate([rng.uniform(-6, 70, (2, 17, 2)), rng.rand(2, 17, 1)],
                        -1).astype(np.float32)
    kp[0, 0, :2] = (10.5, 12.5)                      # halves round to even
    got_s = TV.silhouette_overlay_vis(torch.as_tensor(img), torch.as_tensor(sil)).numpy()
    got_k = TV.keypoints_vis(torch.as_tensor(img), torch.as_tensor(kp)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got_s[i], JV.silhouette_overlay_vis(img[i], sil[i]))
        # cv2.circle's circles and cv2.putText's joint indices, as the JAX vis.
        np.testing.assert_array_equal(got_k[i], JV.keypoints_vis(img[i], kp[i]))


def test_selection_and_crop_match_jax():
    rng = np.random.RandomState(4)
    for _ in range(5):
        masks = np.zeros((4, 60, 60), bool)
        for m in masks:
            r, c = rng.randint(0, 40, 2)
            m[r:r + rng.randint(3, 20), c:c + rng.randint(3, 20)] = True
        valid = rng.rand(4) > 0.3
        boxes = np.sort(rng.uniform(0, 60, (4, 2, 2)), axis=1).reshape(4, 4)[:, [0, 2, 1, 3]]
        assert (TF.get_largest_centred_mask_index(masks, valid, 60, 60)
                == JPERC.get_largest_centred_mask_index(masks, valid, 60, 60))
        assert (TF.get_largest_centred_box_index(boxes, valid, 60, 60)
                == JPERC.get_largest_centred_box_index(boxes, valid, 60, 60))
        img = rng.randint(0, 256, (60, 60, 3)).astype(np.uint8)
        np.testing.assert_array_equal(TP.crop_image_like_proxy(masks[0], img),
                                      JP.crop_image_like_proxy(masks[0], img))
    empty = np.zeros((60, 60), np.float32)
    np.testing.assert_array_equal(TP.crop_image_like_proxy(empty, img),
                                  JP.crop_image_like_proxy(empty, img))


# -------------------------------------------------------- whole slice --

@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    """Three PNGs of other sizes than the frame (one needs odd padding),
    the two detectors' pickles from the port's seeded init (people and
    masks made likely), and a regressor checkpoint whose IEF head returns
    bodies near the T-pose."""
    d = tmp_path_factory.mktemp("slice")
    rng = np.random.RandomState(SEED)
    for i, (h, w) in enumerate(((48, 64), (80, 80), (71, 50))):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img[h // 4:3 * h // 4, w // 3:2 * w // 3] = (200, 150, 100)
        write_png(str(d / "images" / f"im{i}.png"), img)
    pkls = []
    for cls, seed, name in ((TR.KeypointRCNN, 2 * SEED, "kp.pkl"),
                            (TR.PointRendRCNN, 2 * SEED + 1, "pr.pkl")):
        model = TR.init_random_weights(cls(), torch.Generator().manual_seed(seed))
        save_d2_pkl(str(d / name), person_biased(model.state_dict()))
        pkls.append(str(d / name))
    assets = load_synthetic_assets()
    regressor = build_regressor(assets.mean_pose_6d, assets.mean_shape)
    variables = regressor.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 18)), train=False)
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    bias = np.zeros(157, np.float32)
    bias[3:147] = (np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)
                   - np.asarray(assets.mean_pose_6d, np.float32)) / 3
    sd["ief_module.fc3.weight"] = sd["ief_module.fc3.weight"] * np.float32(0.1)
    sd["ief_module.fc3.bias"] = bias
    ckpt = str(d / "straps_model_checkpoint.tar")
    torch.save({"best_model_state_dict": state_dict_to_tensors(sd)}, ckpt)
    return str(d / "images"), pkls, ckpt


def _cfg(cls, images, pkls, ckpt, out_dir):
    cfg = cls(input_dir=images, checkpoint=ckpt, out_dir=out_dir, silhouettes_from="pointrend",
              keypoint_checkpoint=pkls[0], silhouette_checkpoint=pkls[1], img_wh=IMG,
              detector_post_nms_topk=64, detector_max_detections=4)
    cfg.model.compute_dtype = None
    if cls is PredictConfig:
        cfg.detector_image_size, cfg.detector_test_size = FRAME, TEST_SIZE
    return cfg


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _predict_vs_jax(images, pkls, ckpt, tmp_path, monkeypatch, names):
    """predict_3d of the port and of the JAX package over `images`, held to
    the slice's bounds; returns the port's predictions."""
    calls = record_nms(monkeypatch)
    got = TP.predict_3d(_cfg(PredictConfig, images, pkls, ckpt, str(tmp_path / "torch")),
                        device="cpu")
    # No decision of this seed that shapes a detection lies within 1e-4 of
    # its threshold: the NMS IoUs, and the box-NMS candidates' scores.
    assert_nms_margins(calls)
    for boxes, scores, thr, n, idx, valid in calls:
        if thr == 0.5:
            assert ((scores[torch.isfinite(scores)] - 0.05) > 1e-4).all()

    monkeypatch.setattr(JPERC, "DEFAULT_IMAGE_SIZE", FRAME)
    monkeypatch.setattr(JPERC, "DETECTOR_TEST_SIZE", TEST_SIZE)
    want = JP.predict_3d(_cfg(JaxPredictConfig, images, pkls, ckpt, str(tmp_path / "jax")))
    assert got["names"] == want["names"] == names

    sil_agree, joints_close = [], []
    for name in got["names"]:
        sil = [np.load(tmp_path / side / "proxies" / f"{name}_silhouette.npy")
               for side in ("torch", "jax")]
        joints = [np.load(tmp_path / side / "proxies" / f"{name}_joints2D.npy")
                  for side in ("torch", "jax")]
        assert sil[0].shape == (FRAME, FRAME) and joints[0].shape == (17, 2)
        sil_agree.append((sil[0] == sil[1]).mean())
        joints_close.append((np.abs(joints[0] - joints[1]).max(-1) < 0.1).mean())
    assert min(sil_agree) > 0.99 and np.mean([s.mean() for s in sil]) > 0.02
    assert min(joints_close) > 0.8
    for k in NPY_KEYS:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-3 * scale, k
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    # verts_vis: matplotlib's figure of the JAX predictions, held to
    # torch_figures.BOUNDS.
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
    return got


def test_predict_3d_from_images_vs_jax(slice_inputs, tmp_path, monkeypatch):
    images, pkls, ckpt = slice_inputs
    got = _predict_vs_jax(images, pkls, ckpt, tmp_path, monkeypatch, ["im0", "im1", "im2"])
    # The cached proxies the run wrote reproduce its predictions.
    cached_cfg = PredictConfig(input_dir=str(tmp_path / "torch" / "proxies"), checkpoint=ckpt,
                               img_wh=IMG, out_dir=str(tmp_path / "cached"))
    cached_cfg.model.compute_dtype = None
    cached = TP.predict_3d(cached_cfg, device="cpu")
    for k in NPY_KEYS:
        np.testing.assert_array_equal(cached[k], got[k])


def test_cli_runs_the_image_path(slice_inputs, tmp_path, capsys):
    images, pkls, ckpt = slice_inputs
    out = str(tmp_path / "out")
    got = run_predict.main(["--input", images, "--silh-from", "pointrend", "--checkpoint", ckpt,
                            "--keypoint-checkpoint", pkls[0], "--silhouette-checkpoint", pkls[1],
                            "--out-dir", out, "--device", "cpu", f"img_wh={IMG}",
                            "detector_post_nms_topk=32", "detector_max_detections=2",
                            f"detector_image_size={FRAME}", f"detector_test_size={TEST_SIZE}",
                            "detector_backbone_dtype=bfloat16", "--no-vis"])
    assert "predicted 3 images" in capsys.readouterr().out
    assert all(np.isfinite(got[k]).all() for k in NPY_KEYS)
    assert sorted(os.listdir(os.path.join(out, "proxies"))) == sorted(
        f"im{i}_{k}.npy" for i in range(3) for k in ("silhouette", "joints2D"))


def test_random_detectors_need_opting_in(slice_inputs, tmp_path):
    images, _, _ = slice_inputs
    cfg = PredictConfig(input_dir=images, out_dir=str(tmp_path), silhouettes_from="pointrend",
                        img_wh=IMG)
    with pytest.raises(ValueError, match=r"detector checkpoint\(s\) not configured"):
        TP.detect_and_build_proxies(cfg, device="cpu", size=FRAME, test_size=TEST_SIZE)
    cfg.allow_random_detectors = True
    cfg.detector_post_nms_topk, cfg.detector_max_detections = 16, 2
    with pytest.warns(UserWarning, match="RANDOM-WEIGHT DETECTORS"):
        names, proxies, vis = TP.detect_and_build_proxies(cfg, device="cpu", size=FRAME,
                                                          test_size=TEST_SIZE)
    assert names == ["im0", "im1", "im2"] and proxies.shape == (3, IMG, IMG, 18)
    assert vis["joints_vis"].shape == (3, FRAME, FRAME, 3) and len(vis["crops"]) == 3


def test_jpg_inputs_are_refused(slice_inputs, tmp_path, monkeypatch):
    """Only JPEGs of a coding cv2 reads no image from are refused, by
    name.  A folder of PNG and JPEG images is read in the JAX pipeline's
    order (sorted by full path: a PNG and a JPEG of one stem are two
    entries) with the pixels cv2.imread gives, and predict_3d over PNG +
    JPEG agrees with the JAX predict_3d at the slice's bounds."""
    images, pkls, ckpt = slice_inputs
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for name in ("im0.png", "im1.png"):
        os.symlink(os.path.join(images, name), mixed / name)
    im2 = cv2.imread(os.path.join(images, "im2.png"))
    cv2.imwrite(str(mixed / "im2.jpg"), im2, [cv2.IMWRITE_JPEG_QUALITY, 95])
    _predict_vs_jax(str(mixed), pkls, ckpt, tmp_path, monkeypatch, ["im0", "im1", "im2"])

    both = tmp_path / "both"
    both.mkdir()
    for name in ("im0.png", "im1.png", "im2.png"):
        os.symlink(os.path.join(images, name), both / name)
    cv2.imwrite(str(both / "im1.jpg"), im2, [cv2.IMWRITE_JPEG_QUALITY, 60,
                                             cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cv2.imwrite(str(both / "a.jpg"), im2[::-1], [cv2.IMWRITE_JPEG_QUALITY, 80])
    names, frames = TP.read_images(str(both), FRAME, "cpu")
    paths = sorted(glob.glob(str(both / "*.png")) + glob.glob(str(both / "*.jpg")))
    assert names == ["a", "im0", "im1", "im1", "im2"]
    for path, frame in zip(paths, frames.numpy()):
        img = cv2.imread(path)[:, :, ::-1]
        top, left = (max(img.shape[1] - img.shape[0], 0) // 2,
                     max(img.shape[0] - img.shape[1], 0) // 2)
        img = np.pad(img, ((top, top), (left, left), (0, 0)))
        np.testing.assert_array_equal(
            frame, cv2.resize(img, (FRAME, FRAME), interpolation=cv2.INTER_LINEAR), path)

    # A 12-bit JPEG, which cv2.imread reads no image from either.
    from torch_jpeg.write_codings import write_jpeg
    (both / "photo.jpg").write_bytes(write_jpeg(im2[::4, ::4, ::-1].astype(np.uint16) << 4,
                                                precision=12))
    assert cv2.imread(str(both / "photo.jpg")) is None
    cfg = _cfg(PredictConfig, str(both), pkls, ckpt, str(tmp_path / "out"))
    with pytest.raises(ValueError, match="photo.jpg: SOF1 precision 12"):
        TP.predict_3d(cfg, device="cpu")


# ------------------------------------------------------ one image API --

def _single_image_detectors(pkls, **kw):
    """The slice's two detectors in both packages, from the same pickles."""
    from straps_tpu.perception.convert_d2 import load_d2_pkl as jax_load_d2_pkl
    from straps_tpu_torch.perception.convert_d2 import load_d2_pkl, load_detector_state
    kw = dict(post_nms_topk=64, max_detections=4, **kw)
    ours = [load_detector_state(cls(**kw), load_d2_pkl(p))
            for cls, p in ((TR.KeypointRCNN, pkls[0]), (TR.PointRendRCNN, pkls[1]))]
    theirs = [(cls(**kw), jax_load_d2_pkl(p))
              for cls, p in ((JPERC.KeypointRCNN, pkls[0]), (JPERC.PointRendRCNN, pkls[1]))]
    return ours, theirs


@pytest.mark.parametrize("output_size,test_size", [(FRAME, TEST_SIZE), (0, TEST_SIZE), (0, None)])
def test_single_image_api_matches_jax(slice_inputs, monkeypatch, output_size, test_size):
    """`predict_joints2d` and `predict_silhouette` on one of the slice's
    frames against the JAX functions: joints within 0.1 px where the
    keypoint argmax agrees (on 80% of them), boxes within 1e-3 px,
    silhouettes equal on 99% of pixels, in the frame `output_size` and
    `test_size` set."""
    images, pkls, _ = slice_inputs
    frame = TP.read_images(images, FRAME, "cpu")[1][1].numpy()
    (kp, pr), ((jkp, jkp_vars), (jpr, jpr_vars)) = _single_image_detectors(
        pkls, output_size=output_size)
    calls = record_nms(monkeypatch)
    joints, boxes = TF.predict_joints2d(frame, kp, test_size=test_size, device="cpu")
    sil = TF.predict_silhouette(frame, pr, test_size=test_size, device="cpu")
    assert_nms_margins(calls)
    want_joints, want_boxes = JPERC.predict_joints2d(frame, jkp, jkp_vars, test_size=test_size)
    want_sil = JPERC.predict_silhouette(frame, jpr, jpr_vars, test_size=test_size)
    side = output_size or test_size or FRAME
    assert joints.shape == (17, 3) and sil.shape == want_sil.shape == (side, side)
    assert sil.dtype == np.float32 and want_sil.mean() > 0.02
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), atol=1e-3)
    assert (np.abs(joints[:, :2] - want_joints[:, :2]).max(-1) < 0.1).mean() > 0.8
    np.testing.assert_allclose(joints[:, 2], want_joints[:, 2], atol=1e-3)
    assert (sil == want_sil).mean() > 0.99


def test_single_image_api_finds_nobody_as_jax(slice_inputs):
    """Nobody found (a score threshold no detection clears): zeros of the
    model's frame, as the JAX functions return them."""
    images, pkls, _ = slice_inputs
    frame = TP.read_images(images, FRAME, "cpu")[1][0].numpy()
    (kp, pr), ((jkp, jkp_vars), (jpr, jpr_vars)) = _single_image_detectors(
        pkls, output_size=FRAME, score_thresh=1.01)
    joints, _ = TF.predict_joints2d(frame, kp, test_size=TEST_SIZE, device="cpu")
    sil = TF.predict_silhouette(frame, pr, test_size=TEST_SIZE, device="cpu")
    want_sil = JPERC.predict_silhouette(frame, jpr, jpr_vars, test_size=TEST_SIZE)
    np.testing.assert_array_equal(joints, JPERC.predict_joints2d(frame, jkp, jkp_vars,
                                                                 test_size=TEST_SIZE)[0])
    np.testing.assert_array_equal(sil, want_sil)
    assert not joints.any() and sil.shape == (FRAME, FRAME) and not sil.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TF.predict_silhouette(frame, pr, test_size=TEST_SIZE)
