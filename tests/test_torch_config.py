"""The JAX package's `render` and `smpl_precision` training keys in the
port's config: the JAX command lines and YAML files that name them load in
both packages to the same values, they leave the port's training step
unchanged, and a value the JAX training step raises on is refused naming
the key (the JAX package raises in `render_part_seg` on an unknown
backend and in its SMPL einsums on an unknown precision)."""

import dataclasses

import numpy as np
import pytest
import torch

from straps_tpu.config import TrainConfig as JaxTrainConfig
from straps_tpu.config import load_config as jax_load_config
from straps_tpu_torch.config import SMPL_PRECISIONS, TrainConfig, load_config
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.train.loop import build_training
from straps_tpu_torch.train.synthetic import draw_synthetic
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

OVERRIDES = ["render.backend=xla", "render.interpret=true", "smpl_precision=highest"]


def test_jax_overrides_load_in_both_packages():
    got = load_config(TrainConfig, None, OVERRIDES)
    want = jax_load_config(JaxTrainConfig, None, OVERRIDES)
    assert (got.render.backend, got.render.interpret, got.smpl_precision) == \
        ("xla", "true", "highest")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_render_yaml_loads_in_both_packages(tmp_path):
    path = tmp_path / "train.yaml"
    path.write_text("batch_size: 8\nrender:\n  backend: xla\n  interpret: true\n"
                    "smpl_precision: null\nmodel:\n  resnet_layers: 34\n")
    for overrides in ([], OVERRIDES, ["render.backend=pallas", "smpl_precision=default"]):
        got = load_config(TrainConfig, str(path), overrides)
        want = jax_load_config(JaxTrainConfig, str(path), overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), overrides
    got = load_config(TrainConfig, str(path))
    assert (got.render.backend, got.render.interpret, got.smpl_precision,
            got.model.resnet_layers) == ("xla", True, None, 34)


def _one_step(assets, overrides):
    """Loss, task losses and state digest after one train step, and the
    loss of one val step, at 64x64, B=2, from seed 0."""
    cfg = load_config(TrainConfig, None, ["img_wh=64", "batch_size=2", "focal_length=1250.0"]
                      + overrides)
    _, assets, state, train_step, val_step = build_training(cfg, assets, device="cpu")
    rng = np.random.RandomState(0)
    pose = torch.tensor((rng.randn(2, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(2, 10) * 0.5).astype(np.float32))
    draws = draw_synthetic(torch.Generator().manual_seed(0), 2, assets.num_verts, cfg, "cpu")
    loss, task_losses, _ = train_step(state, draws, pose, shape)
    val_loss = val_step(state, pose, shape)[0]
    return (float(loss), {k: float(v) for k, v in task_losses.items()}, state.digest(),
            float(val_loss))


def test_the_keys_leave_the_step_unchanged():
    assets = load_synthetic_assets(device="cpu")
    want = _one_step(assets, [])
    for overrides in (OVERRIDES, ["render.backend=pallas", "render.interpret=True",
                                  "smpl_precision=None"]):
        assert _one_step(assets, overrides) == want, overrides


@pytest.mark.parametrize("key,value", [("render.backend", "'foo'"), ("render.backend", "'XLA'"),
                                       ("smpl_precision", "'foo'"),
                                       ("smpl_precision", "'HIGHEST'")])
def test_values_the_jax_step_raises_on_are_refused(key, value):
    """The port's step builders refuse the value, naming the key; the JAX
    function that the JAX step reaches with it raises."""
    import jax
    import jax.numpy as jnp

    from straps_tpu.render.renderer import render_part_seg
    from straps_tpu_torch.train.step import make_train_step, make_val_step

    cfg = load_config(TrainConfig, None, [f"{key}={value}"])
    for make in (make_train_step, make_val_step):
        with pytest.raises(ValueError, match=key.replace(".", r"\.")):
            make(None, cfg)
    if key == "render.backend":
        tri = jnp.asarray([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
        with pytest.raises(ValueError, match="unknown backend"):
            render_part_seg(tri, jnp.asarray([[0.0, 0.0, 5.0]]), jnp.eye(3),
                            jnp.asarray([[0, 1, 2]]), jnp.asarray([1]), 8,
                            backend=cfg.render.backend)
    else:
        with pytest.raises(ValueError, match="Precision argument"):
            jax.eval_shape(lambda a: jnp.einsum("ij,jk->ik", a, a, precision=cfg.smpl_precision),
                           jnp.ones((2, 2)))


def test_every_precision_the_port_accepts_jax_accepts():
    """`SMPL_PRECISIONS` holds exactly values that JAX's einsum (the SMPL
    forward's) takes as `precision`."""
    import jax
    import jax.numpy as jnp

    for p in SMPL_PRECISIONS:
        jax.eval_shape(lambda a: jnp.einsum("ij,jk->ik", a, a, precision=p), jnp.ones((2, 2)))
    assert len(set(SMPL_PRECISIONS)) == len(SMPL_PRECISIONS)
    assert JaxTrainConfig().smpl_precision in SMPL_PRECISIONS
