"""The PyTorch port's regressor against the JAX package on the same weights.

JAX `model.init` (with its BatchNorm statistics and scales perturbed, so
that the conversion of every leaf shows) -> `flax_to_torch_state_dict` ->
`load_state_dict(strict=True)`.  At float32, cam/pose/shape agree to atol
1e-4 (convolutions sum in another order).  With the bfloat16 encoder both
sides round at different places: atol 0.02 on outputs of order 1 (0.007
measured at 64x64).
The serving rollout (`make_predict_fn`) is held at float32 end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.models import build_regressor as jax_build
from straps_tpu.predict.pipeline import make_predict_fn as jax_predict_fn
from straps_tpu.smpl import load_synthetic_assets
from straps_tpu_torch.config import PredictConfig
from straps_tpu_torch.models.convert import (
    flax_to_torch_state_dict, load_reference_checkpoint, state_dict_to_tensors,
)
from straps_tpu_torch.models.regressor import build_regressor
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMG = 64


@pytest.fixture(scope="module")
def jax_variables():
    assets = load_synthetic_assets()
    model = jax_build(assets.mean_pose_6d, assets.mean_shape)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 18)),
                           train=False)
    rng = np.random.RandomState(0)

    def perturb(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        if name == "scale":
            return jnp.asarray(rng.uniform(0.8, 1.2, x.shape).astype(np.float32))
        return jnp.asarray(x)

    return assets, jax.tree_util.tree_map_with_path(perturb, variables)


def _proxies(seed, B=3):
    rng = np.random.RandomState(seed)
    p = rng.rand(B, IMG, IMG, 18).astype(np.float32)
    p[..., 0] = p[..., 0] > 0.5
    return p


def _torch_model(assets, variables, compute_dtype):
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape,
                            compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_to_tensors(flax_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, variables))), strict=True)
    return model.eval()


@pytest.mark.parametrize("compute_dtype,atol", [(None, 1e-4), ("bfloat16", 0.02)])
def test_forward_matches_flax(jax_variables, compute_dtype, atol):
    assets, variables = jax_variables
    proxies = _proxies(1)
    jmodel = jax_build(assets.mean_pose_6d, assets.mean_shape,
                       compute_dtype=compute_dtype)
    want = jmodel.apply(variables, jnp.asarray(proxies), train=False)
    with torch.inference_mode():
        got = _torch_model(assets, variables, compute_dtype)(torch.as_tensor(proxies))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_converted_keys_are_reference_names(jax_variables):
    assets, variables = jax_variables
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    assert sd["image_encoder.conv1.weight"].shape == (64, 18, 7, 7)
    assert sd["image_encoder.layer2.0.downsample.0.weight"].shape == (128, 64, 1, 1)
    assert "image_encoder.layer2.0.downsample.1.running_var" in sd
    assert sd["ief_module.fc3.weight"].shape == (157, 512)
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape)
    assert set(sd) == set(model.state_dict())


def test_reference_checkpoint_and_predict_rollout(jax_variables, tmp_path):
    """A reference-format .tar loads strictly and resolves to the legacy
    heatmap mode; the float32 rollout matches the JAX rollout."""
    assets, variables = jax_variables
    sd = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    path = str(tmp_path / "ckpt.tar")
    torch.save({"best_model_state_dict": state_dict_to_tensors(sd), "epoch": 3}, path)
    assert set(load_reference_checkpoint(path)) == set(sd)

    cfg = PredictConfig(checkpoint=path, img_wh=IMG)
    cfg.model.compute_dtype = None
    tassets = torch_assets(device="cpu")
    model, mode = TP.load_regressor_variables(cfg, tassets, device="cpu")
    assert mode == "legacy"
    proxies = _proxies(2)
    got = TP.make_predict_fn(model, tassets, IMG)(torch.as_tensor(proxies))
    want = jax_predict_fn(jax_build(assets.mean_pose_6d, assets.mean_shape),
                          variables, assets, IMG)(jnp.asarray(proxies))
    for key, atol in (("cam_wp", 1e-4), ("shape", 1e-4), ("pose_rotmats", 1e-4),
                      ("verts", 1e-4), ("reposed_verts", 1e-4),
                      ("joints3d_all", 1e-4), ("cam_t", 1e-2), ("joints2d", 1e-2)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=1e-4, err_msg=key)


def test_random_init_is_seeded_and_heatmap_mode_resolves():
    tassets = torch_assets(device="cpu")
    cfg = PredictConfig(img_wh=IMG)
    m1, mode = TP.load_regressor_variables(cfg, tassets, device="cpu", seed=3)
    m2, _ = TP.load_regressor_variables(cfg, tassets, device="cpu", seed=3)
    assert mode == "clean"
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    assert TP.resolve_heatmap_mode("auto", "legacy", "x") == "legacy"
    with pytest.warns(UserWarning, match="contradicts"):
        assert TP.resolve_heatmap_mode("clean", "legacy", "x") == "clean"
    with pytest.raises(ValueError):
        TP.resolve_heatmap_mode("bogus", None, "x")
    cfg.checkpoint = "some/orbax/dir"
    with pytest.raises(NotImplementedError, match="orbax"):
        TP.load_regressor_variables(cfg, tassets, device="cpu")
