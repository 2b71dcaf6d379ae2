"""The port's synthetic body model (`straps_tpu_torch/smpl/fixtures.py`,
its own copy of the JAX package's generator) and
`smpl/assets.py::load_synthetic_assets(seed=...)` against the JAX
package's: the arrays bit for bit at several seeds, seed 0 equal to the
committed `assets/synthetic_smpl.npz`, and the loader's behaviour (seed 0
read from the npz, or generated and written there when it is missing;
other seeds generated)."""

import os

import numpy as np
import pytest
import torch

from straps_tpu_torch.smpl import assets as TAS
from straps_tpu_torch.smpl.fixtures import GRID_COLS, GRID_ROWS, generate_synthetic_smpl_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _assert_same_arrays(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_generator_equals_the_jax_package_bit_for_bit(seed):
    from straps_tpu.smpl.fixtures import GRID_COLS as JC, GRID_ROWS as JR
    from straps_tpu.smpl.fixtures import generate_synthetic_smpl_arrays as jax_generate
    assert (GRID_ROWS, GRID_COLS) == (JR, JC)
    _assert_same_arrays(generate_synthetic_smpl_arrays(seed), jax_generate(seed))


def test_seed_0_is_the_committed_npz():
    with np.load(TAS.SYNTHETIC_ASSETS) as f:
        _assert_same_arrays(generate_synthetic_smpl_arrays(0), dict(f))


def test_seeds_give_different_bodies():
    a, b = generate_synthetic_smpl_arrays(1), generate_synthetic_smpl_arrays(2)
    assert not np.array_equal(a["posedirs"], b["posedirs"])
    np.testing.assert_array_equal(a["v_template"], b["v_template"])


def _assets_arrays(assets) -> dict:
    return {k: getattr(assets, k).numpy() for k in TAS._TENSOR_FIELDS + ("faces", "face_parts")}


@pytest.mark.parametrize("seed", (0, 3))
def test_load_synthetic_assets_equals_the_jax_loader(seed):
    from straps_tpu.smpl.assets import load_synthetic_assets as jax_load
    ours = TAS.load_synthetic_assets(device="cpu", seed=seed)
    theirs = jax_load(seed=seed)
    assert ours.is_synthetic and ours.device == torch.device("cpu")
    for k, v in _assets_arrays(ours).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(theirs, k)), err_msg=k)
    assert ours.parents == tuple(int(p) for p in np.asarray(theirs.parents))


def test_missing_npz_is_generated_and_written(tmp_path, monkeypatch):
    path = tmp_path / "assets" / "synthetic_smpl.npz"
    monkeypatch.setattr(TAS, "SYNTHETIC_ASSETS", str(path))
    generated = TAS.load_synthetic_assets(device="cpu")
    assert path.exists()
    with np.load(path) as f:
        _assert_same_arrays(dict(f), generate_synthetic_smpl_arrays(0))
    again = TAS.load_synthetic_assets(device="cpu")
    for k, v in _assets_arrays(generated).items():
        np.testing.assert_array_equal(v, getattr(again, k).numpy(), err_msg=k)
    os.remove(path)
    TAS.load_synthetic_assets(device="cpu", seed=5)
    assert not path.exists()                      # other seeds write nothing
