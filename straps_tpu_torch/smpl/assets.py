"""SMPL asset container and loaders: real SMPL files or the synthetic fixture
(counterpart of `straps_tpu/smpl/assets.py`).

Real-file layout: a directory with `SMPL_NEUTRAL.pkl` (or gendered
variants, chumpy-stripped), and beside it `J_regressor_extra.npy`,
`cocoplus_regressor.npy` and `J_regressor_h36m.npy`; per-face part ids come
from `vertex_texture.npy` + `cube_parts.npy` when present.
"""

import dataclasses
import os
import pickle
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from straps_tpu_torch import constants as C
from straps_tpu_torch.smpl.fixtures import generate_synthetic_smpl_arrays
from straps_tpu_torch.utils.device import resolve_device

SYNTHETIC_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets", "synthetic_smpl.npz")

_TENSOR_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "J_regressor_extra", "J_regressor_cocoplus",
                  "J_regressor_h36m")


@dataclass(frozen=True)
class SmplAssets:
    """Body-model tensors on one device."""
    v_template: torch.Tensor        # (V, 3)
    shapedirs: torch.Tensor         # (V, 3, n_betas)
    posedirs: torch.Tensor          # (23*9, V*3)
    J_regressor: torch.Tensor       # (24, V)
    lbs_weights: torch.Tensor       # (V, 24)
    faces: torch.Tensor             # (F, 3) int32
    parents: tuple                  # (24,) ints
    J_regressor_extra: torch.Tensor     # (9, V)
    J_regressor_cocoplus: torch.Tensor  # (19, V)
    J_regressor_h36m: torch.Tensor      # (17, V)
    face_parts: torch.Tensor        # (F,) int32 body-part id per face
    mean_pose_6d: tuple             # (144,) IEF initial pose
    mean_shape: tuple               # (10,) IEF initial shape
    is_synthetic: bool = False
    # The synthetic batch's CUDA graphs by key (`train/synthetic.py`), which
    # read these tensors: freed with them, and not carried over by `to`.
    synth_graphs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SmplAssets":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _to_assets(d: dict, device="cpu", is_synthetic: bool = False) -> SmplAssets:
    # The packed rasteriser stores part ids in the depth's low 3 mantissa
    # bits (render/cuda_raster.py ATTR_BITS).
    fp = np.asarray(d["face_parts"])
    if fp.min() < 0 or fp.max() > 7:
        raise ValueError(f"face_parts must be in [0, 7], got "
                         f"[{fp.min()}, {fp.max()}]")
    tensors = {k: torch.as_tensor(np.asarray(d[k], np.float32), device=device)
               for k in _TENSOR_FIELDS}
    return SmplAssets(
        faces=torch.as_tensor(np.asarray(d["faces"], np.int32), device=device),
        parents=tuple(int(x) for x in np.asarray(d["parents"])),
        face_parts=torch.as_tensor(fp.astype(np.int32), device=device),
        mean_pose_6d=tuple(float(x) for x in np.asarray(d["mean_pose_6d"])),
        mean_shape=tuple(float(x) for x in np.asarray(d["mean_shape"])),
        is_synthetic=is_synthetic,
        **tensors,
    )


def _dense(x) -> np.ndarray:
    """Densify scipy sparse matrices found in SMPL pkls."""
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_smpl_pkl(pkl_path: str) -> dict:
    """Parse a chumpy-stripped SMPL pickle into numpy arrays.  The file is
    unpickled: pass only body-model files from a trusted source."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    posedirs = np.asarray(data["posedirs"], dtype=np.float32)
    parents = np.asarray(data["kintree_table"][0], dtype=np.int64)
    parents[0] = -1
    return {
        "v_template": np.asarray(data["v_template"], dtype=np.float32),
        "shapedirs": np.asarray(data["shapedirs"], dtype=np.float32)[:, :, :C.NUM_BETAS],
        # smplx convention: posedirs reshaped to (V*3, 207) then transposed.
        "posedirs": posedirs.reshape(-1, posedirs.shape[-1]).T,
        "J_regressor": _dense(data["J_regressor"]).astype(np.float32),
        "lbs_weights": np.asarray(data["weights"], dtype=np.float32),
        "faces": np.asarray(data["f"], dtype=np.int32),
        "parents": parents.astype(np.int32),
    }


def derive_face_parts_from_cube(faces: np.ndarray, vertex_texture: np.ndarray,
                                cube_parts: np.ndarray) -> np.ndarray:
    """Per-face part ids from the reference's colour-cube assets: the face's
    constant colour (texture sample 0) floored at 100*rgb into the LUT."""
    n_faces = int(np.asarray(faces).shape[0])
    tex = np.asarray(vertex_texture, dtype=np.float64).reshape(-1, 3)
    if tex.shape[0] != n_faces:
        if tex.shape[0] % n_faces != 0:
            raise ValueError(
                f"vertex_texture has {tex.shape[0]} colour samples, not a "
                f"multiple of {n_faces} faces")
        tex = tex.reshape(n_faces, -1, 3)[:, 0, :]
    idx = np.floor(100.0 * tex).astype(np.int64)
    cp = np.asarray(cube_parts)
    np.clip(idx, 0, np.asarray(cp.shape)[None, :] - 1, out=idx)
    return cp[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int32)


def load_assets(smpl_dir: Optional[str] = None, gender: str = "neutral",
                device="cuda") -> SmplAssets:
    """Real SMPL assets from `smpl_dir` when its pkl exists, else the
    synthetic fixture, on `device` (`cuda` raises without a card)."""
    device = resolve_device(device)
    if smpl_dir is not None:
        pkl = os.path.join(smpl_dir, f"SMPL_{gender.upper()}.pkl")
        if os.path.exists(pkl):
            d = load_smpl_pkl(pkl)
            root = os.path.dirname(smpl_dir.rstrip("/"))
            for key, fname in [("J_regressor_extra", "J_regressor_extra.npy"),
                               ("J_regressor_cocoplus", "cocoplus_regressor.npy"),
                               ("J_regressor_h36m", "J_regressor_h36m.npy")]:
                path = os.path.join(root, fname)
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"{path} is required alongside {pkl}: the 90-joint "
                        f"superset needs the three extra joint regressors")
                d[key] = np.load(path).astype(np.float32)
            vt_path = os.path.join(root, "vertex_texture.npy")
            cp_path = os.path.join(root, "cube_parts.npy")
            if os.path.exists(vt_path) and os.path.exists(cp_path):
                d["face_parts"] = derive_face_parts_from_cube(
                    d["faces"], np.load(vt_path), np.load(cp_path))
            else:
                joint_part = np.asarray(C.SMPL_JOINT_TO_PART, dtype=np.int32)
                vert_part = joint_part[np.argmax(d["lbs_weights"], axis=1)]
                d["face_parts"] = vert_part[d["faces"][:, 0]].astype(np.int32)
            mp_path = os.path.join(root, "neutral_smpl_mean_params_6dpose.npz")
            if os.path.exists(mp_path):
                mp = np.load(mp_path)
                d["mean_pose_6d"] = mp["pose"].astype(np.float32)
                d["mean_shape"] = mp["shape"].astype(np.float32)
            else:
                d["mean_pose_6d"] = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24)
                d["mean_shape"] = np.zeros(C.NUM_BETAS, np.float32)
            return _to_assets(d, device=device)
    return load_synthetic_assets(device=device)


def load_synthetic_assets(device="cuda", seed: int = 0) -> SmplAssets:
    """The synthetic body model of `smpl/fixtures.py` on `device` (`cuda`
    raises without a card), as the JAX package's loader gives it: seed 0
    is the committed `assets/synthetic_smpl.npz`, generated and written
    there when the file is missing; any other seed is generated."""
    device = resolve_device(device)
    if seed == 0 and os.path.exists(SYNTHETIC_ASSETS):
        with np.load(SYNTHETIC_ASSETS) as f:
            d = dict(f)
    else:
        d = generate_synthetic_smpl_arrays(seed=seed)
        if seed == 0:
            os.makedirs(os.path.dirname(SYNTHETIC_ASSETS), exist_ok=True)
            np.savez_compressed(SYNTHETIC_ASSETS, **d)
    return _to_assets(d, device=device, is_synthetic=True)
