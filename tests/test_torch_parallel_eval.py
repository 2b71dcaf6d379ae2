"""The port's evaluation and predict fan-out over two gloo ranks on the
CPU (64x64, float32 encoder, one torch thread a rank).

`run_evaluation` over two ranks, each synthesising, predicting and
rendering its rows of every batch, gives the one-process metrics within
1e-6 (a padded tail batch included), in the crop frame on synthesised
proxies and in the image frame on a dataset's own silhouettes and joints;
rank 0 alone writes the per-frame metrics.  `make_predict_fn(mesh=)` over
two ranks gives the JAX `make_predict_fn(mesh=make_mesh(2))` predictions
to `tests/test_torch_regressor.py`'s rollout bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.models import build_regressor as jax_build
from straps_tpu.parallel import make_mesh as jax_make_mesh
from straps_tpu.predict.pipeline import make_predict_fn as jax_predict_fn
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.eval_harness.runner import synthesise_proxy_inputs
from straps_tpu_torch.models.convert import flax_to_torch_state_dict, state_dict_to_tensors
from straps_tpu_torch.parallel import launch
from straps_tpu_torch.parallel.dryrun import evaluate, predict
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from test_torch_eval import METRICS, _dataset, checkpoint  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG, TIMEOUT_S = 64, 120


def _cfg(checkpoint):  # noqa: F811
    cfg = PredictConfig(img_wh=IMG, checkpoint=checkpoint)
    cfg.model.compute_dtype = None
    return cfg


def _annotated(n):
    """A dataset that ships silhouettes (96x96) and 2D joints."""
    ds = _dataset(n)
    ds["silhouettes"], ds["joints2D"] = synthesise_proxy_inputs(
        ds["poses"], ds["shapes"], torch_assets(device="cpu"), 96)
    return ds


@pytest.mark.parametrize("iou_frame", ["crop", "image"])
def test_two_ranks_eval_equals_one(checkpoint, tmp_path, iou_frame):  # noqa: F811
    ds = _dataset(7) if iou_frame == "crop" else _annotated(7)
    kw = {"metrics": METRICS, "iou_frame": iou_frame, "save_per_frame": True}
    one = evaluate(ds, _cfg(checkpoint), 4, save_path=str(tmp_path / "one"), **kw)
    two = launch(evaluate, 2, "cpu", args=(ds, _cfg(checkpoint), 4), timeout_s=TIMEOUT_S,
                 kwargs=dict(kw, save_path=str(tmp_path / "two")))
    assert two[0] == two[1] and set(two[0]) == set(METRICS)
    assert one["silhouette_ious"] > 0.2
    for k in METRICS:
        assert abs(two[0][k] - one[k]) <= 1e-6 * max(abs(one[k]), 1.0), k
    for k in METRICS:
        np.testing.assert_allclose(np.load(tmp_path / "two" / f"{k}_per_frame.npy"),
                                   np.load(tmp_path / "one" / f"{k}_per_frame.npy"),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_two_ranks_eval_needs_a_batch_that_splits(checkpoint):  # noqa: F811
    with pytest.raises(RuntimeError, match="ValueError: batch_size 3 does not split over 2"):
        launch(evaluate, 2, "cpu", args=(_dataset(4), _cfg(checkpoint), 3),
               timeout_s=TIMEOUT_S)


def test_predict_fan_out_matches_jax_mesh(tmp_path):
    assets = load_synthetic_assets()
    jmodel = jax_build(assets.mean_pose_6d, assets.mean_shape)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 18)), train=False)
    path = str(tmp_path / "ckpt.tar")
    torch.save({"best_model_state_dict": state_dict_to_tensors(flax_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))}, path)
    rng = np.random.RandomState(2)
    proxies = rng.rand(4, IMG, IMG, 18).astype(np.float32)
    proxies[..., 0] = proxies[..., 0] > 0.5
    want = jax_predict_fn(jmodel, variables, assets, IMG, mesh=jax_make_mesh(2))(
        jnp.asarray(proxies))
    got = launch(predict, 2, "cpu", args=(_cfg(path), proxies), timeout_s=TIMEOUT_S)
    for key, atol in (("cam_wp", 1e-4), ("shape", 1e-4), ("pose_rotmats", 1e-4),
                      ("verts", 1e-4), ("reposed_verts", 1e-4), ("joints3d_all", 1e-4),
                      ("cam_t", 1e-2), ("joints2d", 1e-2)):
        np.testing.assert_array_equal(got[0][key], got[1][key])
        assert got[0][key].shape[0] == 4
        np.testing.assert_allclose(got[0][key], np.asarray(want[key]), atol=atol, rtol=1e-4,
                                   err_msg=key)
