"""Procedural synthetic SMPL-compatible assets.

The reference depends on the licensed `SMPL_NEUTRAL.pkl` body model plus
several regressor `.npy` files (reference `config.py:3-10`,
`models/smpl_official.py:15-25`), none of which can be redistributed.  This
module generates a *synthetic* body model with the exact same tensor shapes
and conventions (6890 vertices, 13776 faces, 24-joint kinematic tree,
10 shape betas, 90-joint superset) so that every code path — LBS, rendering,
training, eval — runs and benches without the licensed files.  When the real
files are present, `straps_tpu_torch.smpl.assets` loads them instead.

The synthetic body is a vertical capsule-grid "humanoid": a 53x130 cylinder
grid whose radius varies with height, giving a closed, watertight-ish mesh
with valid topology for the rasterizer.

The port's copy of `straps_tpu/smpl/fixtures.py` (the port imports nothing
of `straps_tpu`): the same arrays, bit for bit, at every seed.
"""

import numpy as np

from straps_tpu_torch import constants as C

GRID_ROWS = 53
GRID_COLS = 130
assert GRID_ROWS * GRID_COLS == C.NUM_VERTS


def _radius_profile(z01: np.ndarray) -> np.ndarray:
    """Body-ish radius as a function of normalised height in [0, 1]."""
    # Legs (0-0.45), torso (0.45-0.8), head (0.8-1.0).
    r = np.where(z01 < 0.45, 0.10 + 0.04 * z01,
                 np.where(z01 < 0.8, 0.16 + 0.05 * np.sin((z01 - 0.45) * 9.0),
                          0.09 + 0.02 * np.cos((z01 - 0.8) * 15.0)))
    return r.astype(np.float32)


def generate_synthetic_smpl_arrays(seed: int = 0) -> dict:
    """Build the full synthetic asset dict (all numpy, float32)."""
    rng = np.random.RandomState(seed)

    # ---- Template vertices: cylinder grid, y = up (SMPL convention), height ~1.7m.
    zz = np.linspace(0.0, 1.0, GRID_ROWS, dtype=np.float32)
    theta = np.linspace(0.0, 2.0 * np.pi, GRID_COLS, endpoint=False, dtype=np.float32)
    r = _radius_profile(zz)
    ys = (zz * 1.7 - 0.85).astype(np.float32)
    v_template = np.zeros((C.NUM_VERTS, 3), dtype=np.float32)
    for i in range(GRID_ROWS):
        sl = slice(i * GRID_COLS, (i + 1) * GRID_COLS)
        v_template[sl, 0] = r[i] * np.cos(theta)
        v_template[sl, 1] = ys[i]
        v_template[sl, 2] = r[i] * np.sin(theta)

    # ---- Faces: grid quads split into triangles + two fan caps = 13776.
    faces = []
    for i in range(GRID_ROWS - 1):
        for j in range(GRID_COLS):
            a = i * GRID_COLS + j
            b = i * GRID_COLS + (j + 1) % GRID_COLS
            c = (i + 1) * GRID_COLS + j
            d = (i + 1) * GRID_COLS + (j + 1) % GRID_COLS
            faces.append([a, b, c])
            faces.append([b, d, c])
    for j in range(1, GRID_COLS - 1):                       # bottom cap fan
        faces.append([0, j, j + 1])
    top0 = (GRID_ROWS - 1) * GRID_COLS
    for j in range(1, GRID_COLS - 1):                       # top cap fan
        faces.append([top0, top0 + j + 1, top0 + j])
    faces = np.asarray(faces, dtype=np.int32)
    assert faces.shape == (C.NUM_FACES, 3), faces.shape

    # ---- Joints: 24 positions along the axis (heights roughly matching the
    # SMPL tree's vertical layout so part bands look sensible).
    joint_heights01 = np.array([
        0.55, 0.50, 0.50, 0.62, 0.28, 0.28, 0.70, 0.06, 0.06, 0.78,
        0.01, 0.01, 0.84, 0.74, 0.74, 0.92, 0.72, 0.72, 0.55, 0.55,
        0.40, 0.40, 0.35, 0.35], dtype=np.float32)
    joint_x = np.array([
        0.0, 0.06, -0.06, 0.0, 0.07, -0.07, 0.0, 0.08, -0.08, 0.0,
        0.08, -0.08, 0.0, 0.05, -0.05, 0.0, 0.17, -0.17, 0.30, -0.30,
        0.45, -0.45, 0.55, -0.55], dtype=np.float32)
    joints = np.stack([joint_x, joint_heights01 * 1.7 - 0.85,
                       np.zeros(24, np.float32)], axis=1)

    # ---- J_regressor: each joint from its nearest vertices (soft weights).
    d2 = np.sum((v_template[None, :, :] - joints[:, None, :]) ** 2, axis=-1)
    J_regressor = np.exp(-d2 / 0.01)
    # keep top-32 per joint, renormalise
    for j in range(24):
        idx = np.argsort(d2[j])[32:]
        J_regressor[j, idx] = 0.0
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    J_regressor = J_regressor.astype(np.float32)
    # Nudge the template so J_regressor @ v_template reproduces the joint
    # positions reasonably (not exact; not required).

    # ---- LBS weights: softmax over negative distance to the 4 nearest joints.
    w = np.exp(-np.sqrt(d2.T) / 0.05)  # (V, 24)
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    w = w * mask
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # ---- Blend shapes: smooth, small, deterministic.
    radial = v_template.copy()
    radial[:, 1] = 0.0
    n = np.linalg.norm(radial, axis=1, keepdims=True) + 1e-8
    radial = radial / n
    shapedirs = np.zeros((C.NUM_VERTS, 3, C.NUM_BETAS), dtype=np.float32)
    for b in range(C.NUM_BETAS):
        band = np.sin((v_template[:, 1] + 0.85) / 1.7 * np.pi * (b + 1))
        shapedirs[:, :, b] = 0.01 * band[:, None] * radial
        shapedirs[:, 1, b] += 0.005 * np.cos(b + v_template[:, 1])
    posedirs = (rng.randn(23 * 9, C.NUM_VERTS * 3).astype(np.float32) * 1e-4)

    # ---- Extra joint regressors (9 extra, 19 cocoplus, 17 h36m): soft
    # one-hot rows over deterministic vertex neighbourhoods.
    def make_regressor(num_joints, salt):
        rr = np.random.RandomState(seed + salt)
        reg = np.zeros((num_joints, C.NUM_VERTS), dtype=np.float32)
        for j in range(num_joints):
            centre = rr.randint(0, C.NUM_VERTS)
            idx = np.argsort(np.sum((v_template - v_template[centre]) ** 2, axis=1))[:16]
            reg[j, idx] = 1.0 / 16.0
        return reg

    J_regressor_extra = make_regressor(9, 1)
    J_regressor_cocoplus = make_regressor(19, 2)
    J_regressor_h36m = make_regressor(17, 3)

    # ---- Per-face part ids from the dominant bone of each face's vertices.
    joint_part = np.asarray(C.SMPL_JOINT_TO_PART, dtype=np.int32)
    vert_bone = np.argmax(lbs_weights, axis=1)           # (V,)
    vert_part = joint_part[vert_bone]                    # (V,)
    face_parts = vert_part[faces[:, 0]].astype(np.int32)  # (F,)

    # ---- Mean parameters: identity rotations in 6D, zero shape.
    ident6d = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24)
    mean_shape = np.zeros(C.NUM_BETAS, np.float32)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": J_regressor,
        "lbs_weights": lbs_weights,
        "faces": faces,
        "parents": np.asarray(C.SMPL_PARENTS, dtype=np.int32),
        "J_regressor_extra": J_regressor_extra,
        "J_regressor_cocoplus": J_regressor_cocoplus,
        "J_regressor_h36m": J_regressor_h36m,
        "face_parts": face_parts,
        "mean_pose_6d": ident6d,
        "mean_shape": mean_shape,
    }
