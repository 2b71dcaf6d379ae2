"""The PyTorch port's geometry against the JAX package on the same inputs.

Tolerances: rotations, cameras, keypoints and alignment atol 1e-5 (float32
math in another order); the crop's silhouette channel exactly (a gather of
the same pixels) and its joints atol 1e-5; heatmaps atol 1e-6 (exp in two
libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.geometry import alignment as JA
from straps_tpu.geometry import bbox as JB
from straps_tpu.geometry import camera as JC
from straps_tpu.geometry import heatmaps as JH
from straps_tpu.geometry import joints as JJ
from straps_tpu.geometry import rotations as JR
from straps_tpu_torch.geometry import alignment as TA
from straps_tpu_torch.geometry import bbox as TB
from straps_tpu_torch.geometry import camera as TC
from straps_tpu_torch.geometry import heatmaps as TH
from straps_tpu_torch.geometry import joints as TJ
from straps_tpu_torch.geometry import rotations as TR
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _both(fn_jax, fn_torch, *arrays):
    """Run the JAX and the torch function on the same numpy inputs."""
    got_j = fn_jax(*[jnp.asarray(a) for a in arrays])
    got_t = fn_torch(*[torch.as_tensor(a) for a in arrays])
    return np.asarray(got_j), got_t.numpy()


ATOL = 1e-5


@pytest.mark.parametrize("name", ["rot6d_to_rotmat", "rodrigues"])
def test_rotations(name):
    rng = np.random.RandomState(0)
    shape = (16, 24, 6) if name == "rot6d_to_rotmat" else (16, 24, 3)
    x = rng.randn(*shape).astype(np.float32)
    if name == "rodrigues":
        x[0, 0] = 0.0                     # the zero-rotation branch
    j, t = _both(getattr(JR, name), getattr(TR, name), x)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_orthographic_and_keypoints():
    rng = np.random.RandomState(1)
    pts = rng.randn(4, 17, 3).astype(np.float32)
    cam = rng.randn(4, 3).astype(np.float32)
    j, t = _both(JC.orthographic_project, TC.orthographic_project, pts, cam)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both(lambda p: JJ.undo_keypoint_normalisation(p, 256),
                 lambda p: TJ.undo_keypoint_normalisation(p, 256), pts[..., :2])
    np.testing.assert_allclose(t, j, atol=1e-4)   # values ~ 1e2
    j, t = _both(lambda p: JJ.normalise_keypoints(p, 256),
                 lambda p: TJ.normalise_keypoints(p, 256), pts[..., :2] * 100)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_perspective_project(batched):
    rng = np.random.RandomState(2)
    pts = rng.randn(3, 20, 3).astype(np.float32)
    R = np.stack([np.eye(3, dtype=np.float32)] * 3) if batched else np.eye(3, dtype=np.float32)
    t = (rng.randn(3, 3) * 0.1 + [0.0, 0.2, 42.0]).astype(np.float32)
    K = TC.get_intrinsics_matrix(64, 64, 1250.0)
    np.testing.assert_array_equal(K, JC.get_intrinsics_matrix(64, 64, 1250.0))
    j, tt = _both(JC.perspective_project, TC.perspective_project, pts, R, t, K)
    np.testing.assert_allclose(tt, j, rtol=1e-6, atol=1e-4)   # pixels ~ 1e2


def test_weak_perspective_to_camera_translation():
    cam = np.random.RandomState(3).rand(8, 3).astype(np.float32) + 0.5
    j, t = _both(lambda c: JC.weak_perspective_to_camera_translation(c, 5000.0, 256),
                 lambda c: TC.weak_perspective_to_camera_translation(c, 5000.0, 256),
                 cam)
    np.testing.assert_allclose(t, j, rtol=1e-6)


@pytest.mark.parametrize("name", ["compute_similarity_transform",
                                  "scale_and_translation_transform"])
def test_alignment(name):
    rng = np.random.RandomState(4)
    S2 = rng.randn(4, 50, 3).astype(np.float32)
    S1 = (S2 @ np.linalg.qr(rng.randn(3, 3))[0].T.astype(np.float32) * 1.3
          + 0.2 + rng.randn(4, 50, 3).astype(np.float32) * 0.05)
    if name == "compute_similarity_transform":
        S1[0] = S2[0] * [-1.0, 1.0, 1.0]       # a reflection: det fix engages
    j, t = _both(getattr(JA, name), getattr(TA, name), S1.astype(np.float32), S2)
    np.testing.assert_allclose(t, j, atol=ATOL)


def _crop_inputs(seed):
    rng = np.random.RandomState(seed)
    sils = np.zeros((4, 96, 80), np.float32)
    sils[0, 10:70, 20:50] = 1.0                 # inside the image
    sils[1, 0:90, 60:80] = 1.0                  # crop leaves the image
    sils[2, 40:41, 7:8] = 1.0                   # one pixel
    sils[3] = rng.rand(96, 80) > 0.97           # scattered
    joints = rng.uniform(-10, 100, (4, 17, 2)).astype(np.float32)
    return sils, joints


@pytest.mark.parametrize("out_wh", [64, 37])
def test_crop_and_resize_padded(out_wh):
    sils, joints = _crop_inputs(5)
    crop_j = [JB.crop_and_resize_padded(jnp.asarray(s), jnp.asarray(j), out_wh)
              for s, j in zip(sils, joints)]
    sil_t, j_t = TB.crop_and_resize_padded(torch.as_tensor(sils),
                                           torch.as_tensor(joints), out_wh)
    np.testing.assert_array_equal(sil_t.numpy(),
                                  np.stack([np.asarray(c[0]) for c in crop_j]))
    np.testing.assert_allclose(j_t.numpy(),
                               np.stack([np.asarray(c[1]) for c in crop_j]),
                               atol=ATOL)


def test_mask_bounding_box_empty_and_full():
    sils, _ = _crop_inputs(6)
    sils[2] = 0.0                               # empty mask -> zeros
    got = torch.stack(TB.mask_bounding_box(torch.as_tensor(sils)), dim=-1).numpy()
    want = np.stack([np.asarray(JB.mask_bounding_box(jnp.asarray(s))) for s in sils])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["clean", "legacy"])
def test_heatmaps(mode):
    rng = np.random.RandomState(7)
    joints = rng.uniform(-12, 76, (3, 17, 2)).astype(np.float32)
    joints[0, 0] = [63.0, 63.0]                 # the end-exclusive border
    j, t = _both(lambda x: JH.joints_to_gaussian_heatmaps(x, 64, mode=mode),
                 lambda x: TH.joints_to_gaussian_heatmaps(x, 64, mode=mode),
                 joints)
    assert t.shape == (3, 17, 64, 64)
    np.testing.assert_allclose(t, j, atol=1e-6)
