"""Evaluation on the released dataset layouts in the PyTorch port: the
SSP-3D and 3DPW loaders (`eval_harness/datasets.py`) and the image-frame
silhouette IoU (`runner.py::silhouette_crop_box`,
`paste_crop_to_image_frame`, `run_evaluation(iou_frame="image")`), against
the JAX package on fixtures written here in the release layouts.

Loaders: arrays equal.  Crop box and inverse paste: exact.  The
image-frame evaluation to the tolerances `tests/test_torch_eval.py` holds
the crop frame to (metrics rel 1e-3, IoU abs 2e-3), with the JAX runner on
its Pallas path in interpret mode, back faces culled.
"""

import functools
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.eval_harness import datasets as JDS
from straps_tpu.eval_harness import runner as jax_runner
from straps_tpu_torch.cli import run_eval as torch_cli
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.eval_harness import datasets as TDS
from straps_tpu_torch.eval_harness import runner as torch_runner
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from test_torch_eval import METRICS, checkpoint  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, FRAME_H, FRAME_W = 8, 96, 80


def _gt(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 72) * 0.2).astype(np.float32), (rng.randn(n, 10) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def ssp3d_root(tmp_path_factory):
    """An SSP-3D release root: `labels.npz` (aliased keys, bytes genders,
    (N, 17, 3) joints, the release's extras) and one grey silhouette PNG
    per entry of `fnames`.  The silhouettes and joints are synthetic
    bodies rendered into a 96x96 frame, then cut to 96x80 (off-centre)."""
    root = tmp_path_factory.mktemp("ssp_3d")
    poses, shapes = _gt(N, 0)
    sils, j2d = torch_runner.synthesise_proxy_inputs(poses, shapes,
                                                     load_synthetic_assets(device="cpu"), FRAME_H)
    sils = sils[:, :, :FRAME_W]
    fnames = [f"im{i:02d}.png" for i in range(N)]
    os.makedirs(root / "silhouettes")
    for f, s in zip(fnames, sils):
        cv2.imwrite(str(root / "silhouettes" / f), (s > 0).astype(np.uint8) * 255)
    conf = np.ones((N, 17, 1), np.float32)
    np.savez(root / "labels.npz", fnames=np.asarray(fnames), pose=poses, betas=shapes,
             genders=np.asarray([b"m", b"f", b"n", b"m", b"f", b"f", b"m", b"n"]),
             joints2D=np.concatenate([j2d, conf], -1), cam_trans=np.zeros((N, 3), np.float32),
             bbox_centres=np.full((N, 2), 48.0, np.float32),
             bbox_whs=np.full((N,), 90.0, np.float32))
    return str(root)


@pytest.fixture(scope="module")
def threedpw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("3dpw")
    os.makedirs(root / "sequenceFiles" / "test")
    rng = np.random.RandomState(1)
    for s in range(2):
        seq = {"poses": [rng.randn(5, 72).astype(np.float64) for _ in range(s + 1)],
               "betas": [rng.randn(300) for _ in range(s + 1)],
               "genders": [b"m", "female"][:s + 1],
               "campose_valid": [rng.rand(5) > 0.3 for _ in range(s + 1)]}
        with open(root / "sequenceFiles" / "test" / f"seq{s}.pkl", "wb") as f:
            pickle.dump(seq, f, protocol=2)
    return str(root)


@pytest.mark.parametrize("layout", ["ssp3d_root", "ssp3d_labels", "3dpw", "aliased_npz"])
def test_release_layouts_load_like_jax(layout, ssp3d_root, threedpw_root, tmp_path):
    if layout == "ssp3d_root":
        path = ssp3d_root
    elif layout == "ssp3d_labels":
        path = os.path.join(ssp3d_root, "labels.npz")
    elif layout == "3dpw":
        path = threedpw_root
    else:
        path = str(tmp_path / "eval.npz")
        poses, shapes = _gt(3, 2)
        np.savez(path, body_poses=poses, smpl_shapes=shapes, gender=np.asarray(["F", "m", "x"]))
    got, want = TDS.load_eval_dataset(path), JDS.load_eval_dataset(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    if layout.startswith("ssp3d"):
        assert got["silhouettes"].shape == (N, FRAME_H, FRAME_W)
        assert got["genders"].tolist() == ["m", "f", "n", "m", "f", "f", "m", "n"]
    if layout == "3dpw":
        assert got["genders"][0] == "m" and got["genders"][-1] == "f"


def test_layout_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no labels.npz"):
        TDS.load_eval_dataset(str(tmp_path))
    np.savez(tmp_path / "x.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="poses/shapes"):
        TDS.load_eval_dataset(str(tmp_path / "x.npz"))


def test_crop_box_and_inverse_paste_match_jax():
    """The crop box of random silhouettes (and of one at the frame's edge,
    whose crop leaves the frame) and the inverse paste of a crop-frame
    silhouette through it: exact."""
    rng = np.random.RandomState(3)
    sils = np.zeros((5, 90, 70), np.float32)
    for s in sils[:4]:
        r, c = rng.randint(0, 60, 2)
        s[r:r + rng.randint(3, 40), c:c + rng.randint(3, 30)] = 1.0
    sils[4, 0:60, 50:70] = 1.0
    for s in sils:
        box = torch_runner.silhouette_crop_box(s)
        assert box == jax_runner.silhouette_crop_box(s)
        crop = (rng.rand(64, 64) > 0.5).astype(np.float32)
        got = torch_runner.paste_crop_to_image_frame(torch.as_tensor(crop), box, 90, 70)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      jax_runner.paste_crop_to_image_frame(crop, box, 90, 70))
    assert torch_runner.silhouette_crop_box(sils[0] * 0) == (0, 0, 1, 1)


def test_image_frame_eval_matches_jax(checkpoint, ssp3d_root, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jax_runner, "default_raster_backend", lambda wh: "pallas")
    monkeypatch.setattr(jax_runner, "render_silhouette",
                        functools.partial(jax_runner.render_silhouette, interpret=True))
    jcfg = JaxPredictConfig(img_wh=64, checkpoint=checkpoint)
    jcfg.model.compute_dtype = None
    cfg = PredictConfig(img_wh=64, checkpoint=checkpoint)
    cfg.model.compute_dtype = None
    out = {}
    for frame in ("image", "crop"):
        want = jax_runner.run_evaluation(JDS.load_eval_dataset(ssp3d_root), jcfg, metrics=METRICS,
                                         batch_size=4, iou_frame=frame)
        got = torch_runner.run_evaluation(TDS.load_eval_dataset(ssp3d_root), cfg,
                                          metrics=METRICS, batch_size=4, device="cpu",
                                          iou_frame=frame)
        assert set(got) == set(METRICS) and want["silhouette_ious"] > 0.2
        for k in METRICS[:-1]:
            assert got[k] == pytest.approx(want[k], rel=1e-3), (frame, k)
        assert abs(got["silhouette_ious"] - want["silhouette_ious"]) <= 2e-3, frame
        out[frame] = got["silhouette_ious"]
    assert out["image"] != out["crop"]
    with pytest.raises(ValueError, match="iou_frame"):
        torch_runner.run_evaluation({}, cfg, device="cpu", iou_frame="screen")


def test_cli_iou_frame_image_on_cpu(checkpoint, ssp3d_root, capsys):  # noqa: F811
    final = torch_cli.main(["--dataset", ssp3d_root, "--checkpoint", checkpoint, "--img-wh", "64",
                            "--batch-size", "4", "--iou-frame", "image", "--device", "cpu",
                            "--metrics", "pves", "silhouette_ious"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == final and set(final) == {"pves", "silhouette_ious"}
    assert 0.2 < final["silhouette_ious"] <= 1.0 and np.isfinite(final["pves"])
