"""The predict path over cached proxies: the PyTorch port's
`save_proxies`, `load_cached_proxies`, `predict_3d` and `run_predict`
against the JAX package's, on the same seeded silhouettes and joints and
the same regressor weights (a reference-format `.tar` written from the
JAX-initialised variables, with the last IEF layer's bias set to the T-pose
and its weight scaled by 0.1, so that the bodies fill the crop and still
vary with the input), float32 encoder compute, 64x64.

Tolerances: proxies as `tests/test_torch_geometry.py` holds the crop and
the heatmaps (silhouette channel exact, heatmaps atol 1e-6); the npy
predictions as `tests/test_torch_eval.py` holds the metrics (rel 1e-3, of
each array's largest magnitude).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.models import build_regressor
from straps_tpu.predict import pipeline as JP
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.cli import run_predict, run_train
from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.data.native_io import load_npy_batch
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, state_dict_to_tensors
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl import assets as TAS
from straps_tpu_torch.train.loop import train
from torch_figures import assert_within_bounds, mpl_scatter, read_rgba, text_mask
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG = 64
NPY_KEYS = ("verts", "shape", "pose_rotmats", "cam_wp")


def _write_inputs(d, n=3, seed=0):
    """Cached silhouettes (96x96, a seeded box each) and (17, 3) joints
    inside them, written through the port's `save_proxies` (the third
    joint column, a confidence, is what detector joints carry)."""
    rng = np.random.RandomState(seed)
    names, sils, joints = [], [], []
    for i in range(n):
        sil = np.zeros((96, 96), np.float32)
        r0, c0 = rng.randint(5, 25, 2)
        sil[r0:r0 + 60, c0:c0 + 35 + 5 * i] = 1.0
        names.append(f"img{i:02d}")
        sils.append(sil)
        j = np.concatenate([rng.uniform([c0, r0], [c0 + 35, r0 + 60], (17, 2)),
                            np.ones((17, 1))], axis=1)
        joints.append(j.astype(np.float32))
    TP.save_proxies(d, names, sils, joints)
    return names, np.stack(sils), np.stack(joints)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    assets = load_synthetic_assets()
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 18)), train=False)
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    bias = np.zeros(157, np.float32)
    bias[3:147] = (np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)
                   - np.asarray(assets.mean_pose_6d, np.float32)) / 3
    sd["ief_module.fc3.weight"] = sd["ief_module.fc3.weight"] * np.float32(0.1)
    sd["ief_module.fc3.bias"] = bias
    path = str(tmp_path_factory.mktemp("ckpt") / "straps_model_checkpoint.tar")
    torch.save({"best_model_state_dict": state_dict_to_tensors(sd)}, path)
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("proxies"))
    return (d,) + _write_inputs(d)


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_save_load_round_trip_vs_jax(inputs):
    d, names, sils, joints = inputs
    for i, name in enumerate(names):
        np.testing.assert_array_equal(np.load(os.path.join(d, f"{name}_silhouette.npy")), sils[i])
        np.testing.assert_array_equal(np.load(os.path.join(d, f"{name}_joints2D.npy")), joints[i])
    got_names, got = TP.load_cached_proxies(d, IMG, heatmap_mode="legacy", device="cpu")
    want_names, want = JP.load_cached_proxies(d, IMG, heatmap_mode="legacy")
    want = np.asarray(want)
    assert got_names == want_names == names and got.shape == (3, IMG, IMG, 18)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    np.testing.assert_allclose(got[..., 1:].numpy(), want[..., 1:], atol=1e-6)
    assert got[..., 0].mean() > 0.2 and got[..., 1:].amax() > 0.9


def test_load_npy_batch_checks_every_header(tmp_path):
    good = [str(tmp_path / f"{i}.npy") for i in range(2)]
    for p in good:
        np.save(p, np.ones((4, 3), np.float64))
    out = load_npy_batch(good, (4, 3))
    assert out.dtype == np.float32 and out.shape == (2, 4, 3) and (out == 1).all()
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.ones((3, 4), np.float32))
    with pytest.raises(ValueError, match="bad.npy"):
        load_npy_batch(good + [bad], (4, 3))
    with pytest.raises(FileNotFoundError, match="silhouette"):
        TP.load_cached_proxies(str(tmp_path), IMG, device="cpu")


def test_predict_3d_vs_jax(checkpoint, inputs, tmp_path):
    d = inputs[0]
    jcfg = JaxPredictConfig(input_dir=d, checkpoint=checkpoint, img_wh=IMG,
                            out_dir=str(tmp_path / "jax"))
    jcfg.model.compute_dtype = None
    want = JP.predict_3d(jcfg)
    cfg = PredictConfig(input_dir=d, checkpoint=checkpoint, img_wh=IMG,
                        out_dir=str(tmp_path / "torch"))
    cfg.model.compute_dtype = None
    got = TP.predict_3d(cfg, device="cpu")
    assert got["names"] == want["names"]
    assert np.abs(want["verts"][1] - want["verts"][0]).max() > 1e-5   # bodies differ
    for k in NPY_KEYS:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-3 * scale, k
        for name in got["names"]:
            np.testing.assert_array_equal(
                np.load(tmp_path / "torch" / f"{name}_{k}.npy"),
                got[k][got["names"].index(name)])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    # verts_vis: the 3D scatter of each body, held to torch_figures.BOUNDS
    # against the JAX file, the tick labels left out.
    for i, name in enumerate(got["names"]):
        base, boxes = mpl_scatter(want["verts"][i], markers=False)
        assert_within_bounds(
            read_rgba(str(tmp_path / "torch" / "verts_vis" / f"verts_{name}.png")),
            read_rgba(str(tmp_path / "jax" / "verts_vis" / f"verts_{name}.png")), base,
            text_mask(boxes, base.shape[:2]))
    # The renders show bodies: the IEF head returns bodies near the T-pose.
    import matplotlib.image as mpimg
    for name in got["names"]:
        for kind in ("rend", "reposed"):
            img = mpimg.imread(str(tmp_path / "torch" / "rend_vis" / f"{kind}_{name}.png"))
            ref = mpimg.imread(str(tmp_path / "jax" / "rend_vis" / f"{kind}_{name}.png"))
            assert img.shape == (IMG, IMG, 3) and (img < 0.98).any(axis=-1).mean() > 0.05
            moved = (np.abs(img - ref[..., :3]) > 1.5 / 255).any(axis=-1).mean()
            assert moved < 0.002, (kind, name, moved)


def test_cli_on_cpu(checkpoint, inputs, tmp_path, capsys):
    out = str(tmp_path / "out")
    got = run_predict.main(["--input", inputs[0], "--checkpoint", checkpoint,
                            "--out-dir", out, "--device", "cpu", f"img_wh={IMG}"])
    assert f"predicted 3 images -> {out}" in capsys.readouterr().out
    assert all(np.isfinite(got[k]).all() for k in NPY_KEYS)
    assert sorted(os.listdir(os.path.join(out, "rend_vis"))) == sorted(
        f"{k}_{n}.png" for k in ("rend", "reposed") for n in inputs[1])
    assert len(os.listdir(os.path.join(out, "proxy_vis"))) == 3

    no_vis = str(tmp_path / "no_vis")
    run_predict.main(["--input", inputs[0], "--out-dir", no_vis, "--no-vis",
                      "--device", "cpu", f"img_wh={IMG}"])
    assert sorted(os.listdir(no_vis)) == sorted(
        f"{n}_{k}.npy" for n in inputs[1] for k in NPY_KEYS)


@pytest.mark.parametrize("argv", [["--silh-from", "densepose"],
                                  ["--silh-from", "densepose", "--allow-random-detectors"],
                                  ["--keypoint-checkpoint", "kp.pkl"],
                                  ["--allow-random-detectors"]])
def test_cli_refuses_detector_path(tmp_path, capsys, argv):
    """`--silh-from densepose` goes to the detector front end, which
    refuses random detectors unless asked for and then a folder without
    images; the detector flags are refused with cached proxies."""
    if "densepose" in argv:
        want = ((FileNotFoundError, "no images in") if "--allow-random-detectors" in argv
                else (ValueError, r"detector checkpoint\(s\) not configured"))
        with pytest.raises(want[0], match=want[1]):
            run_predict.main(["--input", str(tmp_path), "--device", "cpu",
                              "--out-dir", str(tmp_path / "out")] + argv)
        return
    with pytest.raises(SystemExit):
        run_predict.main(["--input", str(tmp_path), "--device", "cpu"] + argv)
    assert "serve only the detector front end" in capsys.readouterr().err


def test_predict_3d_refuses_detector_path(tmp_path):
    """The DensePose front end runs only with detectron2 checkpoints or
    with random detectors asked for; an unknown front end is refused."""
    cfg = PredictConfig(input_dir=str(tmp_path), silhouettes_from="densepose")
    with pytest.raises(ValueError, match=r"detector checkpoint\(s\) not configured"):
        TP.predict_3d(cfg, device="cpu")
    cfg.silhouettes_from = "openpose"
    with pytest.raises(ValueError, match="silhouettes_from must be"):
        TP.predict_3d(cfg, device="cpu")
    with pytest.raises(ValueError, match="silhouettes_from must be one of"):
        TP.build_detector_models(PredictConfig(), 64, device="cpu")


def test_cuda_entry_points_without_card_raise(inputs, tmp_path, monkeypatch):
    """Every entry point defaults to CUDA and raises without a card instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_assets = TAS.load_synthetic_assets(device="cpu")
    calls = [
        lambda: TAS.load_synthetic_assets(),
        lambda: TAS.load_assets(None),
        lambda: TP.load_regressor_variables(PredictConfig(), cpu_assets),
        lambda: TP.load_cached_proxies(inputs[0], IMG),
        lambda: TP.predict_3d(PredictConfig(input_dir=inputs[0], out_dir=str(tmp_path))),
        lambda: run_predict.main(["--input", inputs[0], "--out-dir", str(tmp_path)]),
        lambda: TP.build_detector_models(PredictConfig(silhouettes_from="pointrend"), 64),
        lambda: TP.build_detector_models(PredictConfig(silhouettes_from="densepose"), 64),
        lambda: TP.detect_and_build_proxies(
            PredictConfig(input_dir=inputs[0], silhouettes_from="pointrend",
                          allow_random_detectors=True, out_dir=str(tmp_path))),
        lambda: train(TrainConfig(img_wh=IMG, batch_size=2,
                                  model_save_path=str(tmp_path / "ckpt" / "m"),
                                  log_path=str(tmp_path / "logs" / "l.pkl")),
                      assets=cpu_assets),
        lambda: run_train.main(["--synthetic-data", f"img_wh={IMG}", "batch_size=2",
                                f"log_path={tmp_path / 'logs' / 'l.pkl'}",
                                f"model_save_path={tmp_path / 'ckpt' / 'm'}"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.listdir(tmp_path)
