"""The evaluation slice end to end: the PyTorch port's `run_evaluation`
against the JAX package's, on the same 8-sample synthetic dataset, the same
regressor weights (a reference-format `.tar` written from the JAX-initialised
variables, with the last IEF layer set so that the predicted body fills the
crop), float32 encoder compute, 64x64.

The JAX harness is run as on its TPU: its renders go through the packed
Pallas kernel (in interpret mode here) with back faces culled, which is the
function the port's renders compute.  Vertex and joint metrics agree to
rtol 1e-3; silhouette IoU to abs 2e-3 (an edge pixel may move with float32
vertex rounding).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.eval_harness import runner as jax_runner
from straps_tpu.models import build_regressor
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.cli import run_eval as torch_cli
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.eval_harness import runner as torch_runner
from straps_tpu_torch.models.convert import (
    flax_to_torch_state_dict, state_dict_to_tensors,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

METRICS = ("pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc", "mpjpes",
           "mpjpes_sc", "mpjpes_pa", "silhouette_ious")


def t_pose_bias(mean_pose_6d, ief_iters):
    """IEF `fc3` bias that, with a zero `fc3` weight, moves the initial
    estimate to the mean shape in the T-pose at camera scale 0.9: a body
    that fills the crop, so the silhouette IoU compares non-empty renders.
    The synthetic fixture's mean pose (1, 0, 0, 0, 1, 0) is degenerate
    under `rot6d_to_rotmat`'s (3, 2) reading; the identity is (1, 0, 0, 1, 0, 0)."""
    bias = np.zeros(157, np.float32)
    ident = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)
    bias[3:147] = (ident - np.asarray(mean_pose_6d, np.float32)) / ief_iters
    return bias


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    assets = load_synthetic_assets()
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 18)),
                           train=False)
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    sd["ief_module.fc3.weight"] = np.zeros_like(sd["ief_module.fc3.weight"])
    sd["ief_module.fc3.bias"] = t_pose_bias(assets.mean_pose_6d, 3)
    path = str(tmp_path_factory.mktemp("ckpt") / "straps_model_checkpoint.tar")
    torch.save({"best_model_state_dict": state_dict_to_tensors(sd)}, path)
    return path


def _dataset(n=8):
    rng = np.random.RandomState(0)
    return {
        "poses": (rng.randn(n, 72) * 0.2).astype(np.float32),
        "shapes": (rng.randn(n, 10) * 0.5).astype(np.float32),
        "genders": np.asarray(["n"] * n),
    }


def test_eval_matches_jax(checkpoint, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_runner, "default_raster_backend", lambda wh: "pallas")
    monkeypatch.setattr(jax_runner, "render_silhouette",
                        functools.partial(jax_runner.render_silhouette,
                                          interpret=True))
    jcfg = JaxPredictConfig(img_wh=64, checkpoint=checkpoint)
    jcfg.model.compute_dtype = None
    want = jax_runner.run_evaluation(_dataset(), jcfg, metrics=METRICS,
                                     batch_size=4)

    cfg = PredictConfig(img_wh=64, checkpoint=checkpoint)
    cfg.model.compute_dtype = None
    got = torch_runner.run_evaluation(_dataset(), cfg, metrics=METRICS,
                                      batch_size=4, save_per_frame=True,
                                      save_path=str(tmp_path), device="cpu")
    assert set(got) == set(METRICS)
    assert want["silhouette_ious"] > 0.2
    for k in METRICS[:-1]:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert abs(got["silhouette_ious"] - want["silhouette_ious"]) <= 2e-3
    assert np.load(tmp_path / "pves_per_frame.npy").shape == (8,)


def test_cli_on_cpu(checkpoint, tmp_path, capsys):
    data = tmp_path / "eval.npz"
    np.savez(data, **_dataset(5))
    final = torch_cli.main(["--dataset", str(data), "--checkpoint", checkpoint,
                            "--img-wh", "64", "--batch-size", "4",
                            "--device", "cpu", "--metrics", "pves", "mpjpes_pa",
                            "silhouette_ious"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == final and set(final) == {"pves", "mpjpes_pa", "silhouette_ious"}
    assert all(np.isfinite(v) for v in final.values())
    assert 0.2 < final["silhouette_ious"] <= 1.0


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_runner.run_evaluation(_dataset(2), PredictConfig(img_wh=64),
                                    device="cuda")


def test_partial_annotations_rejected():
    ds = _dataset(2)
    ds["silhouettes"] = np.zeros((2, 64, 64), np.float32)
    with pytest.raises(ValueError, match="no joints2D"):
        torch_runner.run_evaluation(ds, PredictConfig(img_wh=64), device="cpu")


def test_mixed_gender_batches_are_invariant():
    """Per-sample gendered ground truth and the padded tail: one batch of 7
    and batches of 4 give the same metrics."""
    from straps_tpu_torch.smpl.assets import load_assets

    base = load_assets(None, device="cpu")
    gender_assets = {"m": dataclasses.replace(base, v_template=base.v_template + 0.05),
                     "f": dataclasses.replace(base, v_template=base.v_template - 0.05),
                     "n": base}
    ds = _dataset(7)
    ds["genders"] = np.asarray(["m", "f", "n", "m", "f", "n", "m"])
    cfg = PredictConfig(img_wh=64)
    out = [torch_runner.run_evaluation(ds, cfg, metrics=("pves", "pve-ts"),
                                       batch_size=bs, gender_assets=gender_assets,
                                       device="cpu")
           for bs in (4, 7)]
    for k in ("pves", "pve-ts"):
        assert out[0][k] == pytest.approx(out[1][k], rel=1e-4)
    neutral = torch_runner.run_evaluation(ds, cfg, metrics=("pve-ts",), batch_size=4,
                                          device="cpu")
    assert abs(neutral["pve-ts"] - out[0]["pve-ts"]) > 1e-3
