"""The PyTorch port's body model against the JAX package: the synthetic
fixture, and `smpl_forward` on the full-size mesh (vertices and the
90-joint superset, atol 1e-5) for posed, identity-pose and axis-angle
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.smpl import load_synthetic_assets as jax_assets
from straps_tpu.smpl import model as JM
from straps_tpu.train.synthetic import select_joint_sets as jax_select
from straps_tpu_torch.smpl import assets as TAS
from straps_tpu_torch.smpl import model as TM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


@pytest.fixture(scope="module")
def assets():
    return jax_assets(), TAS.load_synthetic_assets(device="cpu")


def test_assets_match_jax(assets):
    ja, ta = assets
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor",
                 "lbs_weights", "faces", "J_regressor_extra",
                 "J_regressor_cocoplus", "J_regressor_h36m", "face_parts"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    assert ta.parents == ja.parents
    assert ta.mean_pose_6d == ja.mean_pose_6d


def test_face_parts_guard():
    with np.load(TAS.SYNTHETIC_ASSETS) as f:
        d = dict(f)
    d["face_parts"] = d["face_parts"].copy()
    d["face_parts"][0] = 8
    with pytest.raises(ValueError, match=r"\[0, 7\]"):
        TAS._to_assets(d)


def _rotmats(rng, B, n):
    from straps_tpu.geometry import rodrigues
    return np.array(rodrigues(jnp.asarray(rng.randn(B, n, 3).astype(np.float32) * 0.4)))


@pytest.mark.parametrize("case", ["posed", "identity", "global_only"])
def test_smpl_forward(assets, case):
    ja, ta = assets
    rng = np.random.RandomState(0)
    B = 3
    betas = rng.randn(B, 10).astype(np.float32)
    body = _rotmats(rng, B, 23) if case == "posed" else None
    glob = _rotmats(rng, B, 1) if case != "identity" else None
    tj = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    tt = lambda a: None if a is None else torch.as_tensor(a)   # noqa: E731
    oj = JM.smpl_forward(ja, jnp.asarray(betas), tj(body), tj(glob))
    ot = TM.smpl_forward(ta, torch.as_tensor(betas), tt(body), tt(glob))
    assert ot.joints.shape == (B, 90, 3)
    np.testing.assert_allclose(ot.vertices.numpy(), np.asarray(oj.vertices), atol=ATOL)
    np.testing.assert_allclose(ot.joints.numpy(), np.asarray(oj.joints), atol=ATOL)
    np.testing.assert_allclose(ot.tree_joints.numpy(), np.asarray(oj.tree_joints),
                               atol=ATOL)


def test_smpl_forward_axis_angle_and_joint_sets(assets):
    ja, ta = assets
    rng = np.random.RandomState(1)
    pose = (rng.randn(2, 72) * 0.3).astype(np.float32)
    betas = (rng.randn(2, 10) * 0.5).astype(np.float32)
    oj = JM.smpl_forward_axis_angle(ja, jnp.asarray(betas), jnp.asarray(pose))
    ot = TM.smpl_forward_axis_angle(ta, torch.as_tensor(betas), torch.as_tensor(pose))
    np.testing.assert_allclose(ot.vertices.numpy(), np.asarray(oj.vertices), atol=ATOL)
    for got, want in zip(TM.select_joint_sets(ot.joints), jax_select(oj.joints)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["NUM_BETAS", "ALL_JOINTS_TO_COCO_MAP",
                                  "ALL_JOINTS_TO_H36M_MAP", "H36M_TO_J14",
                                  "SMPL_VERTEX_IDS", "SMPL_EXTRA_KEYPOINT_ORDER",
                                  "SMPL_JOINT_TO_PART"])
def test_constants_match_jax(name):
    from straps_tpu import constants as jax_constants
    from straps_tpu_torch import constants as torch_constants
    assert getattr(torch_constants, name) == getattr(jax_constants, name)
