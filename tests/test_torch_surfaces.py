"""The port's package surfaces against the JAX package's.

Each `straps_tpu/<sub>/__init__.py` exports names through `__all__`; the
port's `straps_tpu_torch/<sub>/__init__.py` maps each of them in
`JAX_COUNTERPARTS` to port names of its own `__all__` (which resolve), or
to a reason why there is none, and exports nothing that is no JAX name's
counterpart.  The JAX lists are read with `ast`, without importing the
JAX package.  A few names then run through both surfaces on the same
seeded numpy inputs, at the tolerances of the port's module tests
(`tests/test_torch_geometry.py`, `tests/test_torch_smpl.py`: atol 1e-5),
and importing every port surface in a fresh process, from a copy of the
installed files, loads no JAX, flax, orbax, cv2, matplotlib, PIL or
`straps_tpu` and builds nothing.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_isolation import FORBIDDEN
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUBPACKAGES = sorted(p.parent.name for p in (ROOT / "straps_tpu").glob("*/__init__.py")
                     if "__all__" in p.read_text())
ATOL = 1e-5


def jax_all(sub):
    """`straps_tpu.<sub>.__all__`, parsed."""
    tree = ast.parse((ROOT / "straps_tpu" / sub / "__init__.py").read_text())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in node.targets)]
    return names


def test_every_jax_surface_is_listed():
    assert SUBPACKAGES == ["augment", "data", "eval_harness", "geometry", "losses", "metrics",
                           "models", "ops", "parallel", "perception", "predict", "render",
                           "smpl", "train"]
    assert sum(len(jax_all(sub)) for sub in SUBPACKAGES) == 147


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_surface_maps_every_jax_name(sub):
    port = importlib.import_module(f"straps_tpu_torch.{sub}")
    table = port.JAX_COUNTERPARTS
    assert sorted(table) == sorted(jax_all(sub))
    assert len(set(port.__all__)) == len(port.__all__)
    named = set()
    for name, counterpart in table.items():
        if isinstance(counterpart, str):
            assert counterpart.strip() and "\n" not in counterpart, name
            continue
        assert isinstance(counterpart, tuple) and counterpart, name
        for p in counterpart:
            assert p in port.__all__ and getattr(port, p) is not None, (name, p)
        named.update(counterpart)
    # The port exports no name that is no JAX name's counterpart.
    assert named == set(port.__all__)


def test_the_documented_imports_work():
    from straps_tpu_torch.geometry import procrustes_align, rot6d_to_rotmat
    from straps_tpu_torch.train import build_training, make_train_step
    assert callable(rot6d_to_rotmat) and callable(make_train_step) and callable(build_training)
    from straps_tpu_torch.geometry import compute_similarity_transform
    assert procrustes_align is compute_similarity_transform


# -------------------------------------------------- through both surfaces
def test_geometry_through_both_surfaces():
    import jax.numpy as jnp

    import straps_tpu.geometry as JG
    import straps_tpu_torch.geometry as TG
    rng = np.random.RandomState(16)
    x6 = rng.randn(8, 24, 6).astype(np.float32)
    np.testing.assert_allclose(TG.rot6d_to_rotmat(torch.as_tensor(x6)).numpy(),
                               np.asarray(JG.rot6d_to_rotmat(jnp.asarray(x6))), atol=ATOL)
    S2 = rng.randn(4, 50, 3).astype(np.float32)
    S1 = (S2 @ np.linalg.qr(rng.randn(3, 3))[0].T.astype(np.float32) * 1.3 + 0.2
          + rng.randn(4, 50, 3).astype(np.float32) * 0.05)
    S1[0] = S2[0] * [-1.0, 1.0, 1.0]              # a reflection: det fix engages
    np.testing.assert_allclose(
        TG.procrustes_align(torch.as_tensor(S1), torch.as_tensor(S2)).numpy(),
        np.asarray(JG.procrustes_align(jnp.asarray(S1), jnp.asarray(S2))), atol=ATOL)


def test_smpl_and_joint_sets_through_both_surfaces():
    import jax.numpy as jnp

    import straps_tpu.smpl as JS
    import straps_tpu.train as JT
    import straps_tpu_torch.smpl as TS
    import straps_tpu_torch.train as TT
    from straps_tpu.geometry import rodrigues
    rng = np.random.RandomState(17)
    betas = rng.randn(3, 10).astype(np.float32)
    body = np.array(rodrigues(jnp.asarray(rng.randn(3, 23, 3).astype(np.float32) * 0.4)))
    ja, ta = JS.load_synthetic_assets(), TS.load_synthetic_assets(device="cpu")
    oj = JS.smpl_forward(ja, jnp.asarray(betas), jnp.asarray(body))
    ot = TS.smpl_forward(ta, torch.as_tensor(betas), torch.as_tensor(body))
    np.testing.assert_allclose(ot.vertices.numpy(), np.asarray(oj.vertices), atol=ATOL)
    np.testing.assert_allclose(ot.joints.numpy(), np.asarray(oj.joints), atol=ATOL)
    for got, want in zip(TT.select_joint_sets(ot.joints), JT.select_joint_sets(oj.joints)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_constants_through_both_surfaces():
    import straps_tpu.losses as JL
    import straps_tpu.render as JR
    import straps_tpu_torch.losses as TL
    import straps_tpu_torch.render as TR
    assert TL.ALL_TASKS == JL.ALL_TASKS
    assert TR.FACE_CHUNK == JR.FACE_CHUNK


def test_load_eval_npz_through_both_surfaces(tmp_path):
    import straps_tpu.eval_harness as JE
    import straps_tpu_torch.eval_harness as TE
    rng = np.random.RandomState(18)
    path = str(tmp_path / "eval.npz")
    np.savez(path, poses=rng.randn(5, 72).astype(np.float32),
             shapes=rng.randn(5, 10).astype(np.float32), genders=np.array(list("mfnmf")))
    got, want = TE.load_eval_npz(path), JE.load_eval_npz(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, poses=rng.randn(2, 72).astype(np.float32))
    with pytest.raises(ValueError, match="poses/shapes"):
        TE.load_eval_npz(bad)
    with pytest.raises(AssertionError, match="poses/shapes"):
        JE.load_eval_npz(bad)


def test_make_optimizer_steps_as_optax():
    """Three Adam steps of `make_optimizer` on seeded gradients against
    the JAX package's `make_optimizer` (optax) on the same ones."""
    import jax.numpy as jnp
    import optax

    import straps_tpu.train as JT
    import straps_tpu_torch.train as TT
    rng = np.random.RandomState(19)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    w = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    opt = TT.make_optimizer([w], 1e-2)
    tx = JT.make_optimizer(1e-2)
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    for g in grads:
        w.grad = torch.as_tensor(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=ATOL)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


def test_train_state_uses_make_optimizer():
    from straps_tpu_torch.models import build_regressor
    from straps_tpu_torch.smpl import load_synthetic_assets
    from straps_tpu_torch.train import create_train_state
    assets = load_synthetic_assets(device="cpu")
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape, resnet_layers=18,
                            compute_dtype=None)
    log_vars = {"verts": torch.zeros((), requires_grad=True)}
    state = create_train_state(model, log_vars, 3e-4)
    (group,) = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"]) == (3e-4, (0.9, 0.999), 1e-8)
    assert group["params"][-1] is log_vars["verts"]
    assert len(group["params"]) == len(list(model.parameters())) + 1


# ------------------------------------------------- importing builds nothing
def test_importing_every_surface_loads_nothing_forbidden_and_builds_nothing(tmp_path):
    """In a fresh process whose only copy of the port is the installed
    files (`utils/package_copy.py`), importing every surface and resolving
    every name loads no forbidden module, no kernel and no host library,
    and writes no `_build/`."""
    from straps_tpu_torch.utils.package_copy import copy_package
    site = tmp_path / "site"
    copy_package(str(ROOT), str(site))
    code = f"""
import importlib, os, sys
sys.path.insert(0, {str(site)!r})
import straps_tpu_torch
assert straps_tpu_torch.__file__.startswith({str(site)!r}), straps_tpu_torch.__file__
for sub in {SUBPACKAGES!r}:
    m = importlib.import_module("straps_tpu_torch." + sub)
    for name in m.__all__:
        getattr(m, name)
from straps_tpu_torch.utils import native_build
assert native_build.KERNEL_LIBRARIES and native_build._LIBRARIES == {{}}
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
assert not os.path.exists(native_build.BUILD_DIR), os.listdir(native_build.BUILD_DIR)
print("ok", len(sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert not (site / "straps_tpu_torch" / "_build").exists()

