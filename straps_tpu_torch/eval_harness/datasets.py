"""Evaluation datasets (counterpart of `straps_tpu/eval_harness/datasets.py`).

The canonical eval dict: poses (N, 72), shapes (N, 10), genders (N,),
optionally silhouettes (N, H, W) and joints2D (N, 17, 2|3).  SSP-3D ships
as a `labels.npz` beside `silhouettes/` and `images/` folders, 3DPW as
per-sequence pickles; `load_eval_dataset` reads either release layout, or
a canonical npz, with the key aliases of the common public releases.
Silhouette PNGs are read by `utils/png.py::decode_png_grey`, as the JAX
package's `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`.
"""

import glob
import os
import pickle
from typing import Dict, Optional

import numpy as np

from straps_tpu_torch.utils.png import decode_png_grey

_POSE_KEYS = ("poses", "pose", "body_poses", "smpl_poses")
_SHAPE_KEYS = ("shapes", "shape", "betas", "bodyshapes", "smpl_shapes")
_GENDER_KEYS = ("genders", "gender")
_JOINTS_KEYS = ("joints2D", "joints2d", "keypoints2d")


def _first_key(data: Dict[str, np.ndarray], keys) -> Optional[str]:
    for k in keys:
        if k in data:
            return k
    return None


def normalise_gender(g) -> str:
    """-> 'm' / 'f' / 'n'.  Bytes are decoded first: str(b'm') is "b'm'"."""
    if isinstance(g, (bytes, np.bytes_)):
        g = g.decode("utf-8", "replace")
    s = str(g).lower()[:1]
    return s if s in ("m", "f") else "n"


def load_ssp3d(labels_path: str, silhouette_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    """An SSP-3D-style labels npz (key aliases accepted), and, where
    `silhouette_dir` has a `<fname>.npy` or `<fname>.png` for every entry
    of `fnames`, the silhouettes: an npy as float32, a PNG as
    `cv2.imread(path, cv2.IMREAD_GRAYSCALE) > 0` (any colour type and
    depth: a colour PNG's grey is libpng's weighted sum, not a channel).
    Genders become 'm' / 'f' / 'n'; the release's `cam_trans`,
    `bbox_centres` and `bbox_whs` ride along."""
    data = dict(np.load(labels_path, allow_pickle=True))
    pk = _first_key(data, _POSE_KEYS)
    sk = _first_key(data, _SHAPE_KEYS)
    if not (pk and sk):
        raise ValueError(f"no pose/shape keys in {labels_path}: {list(data)}")
    out: Dict[str, np.ndarray] = {
        "poses": np.asarray(data[pk], np.float32).reshape(-1, 72),
        "shapes": np.asarray(data[sk], np.float32).reshape(-1, 10),
    }
    gk = _first_key(data, _GENDER_KEYS)
    if gk is not None:
        out["genders"] = np.asarray([normalise_gender(g) for g in data[gk]])
    jk = _first_key(data, _JOINTS_KEYS)
    if jk is not None:
        out["joints2D"] = np.asarray(data[jk], np.float32)[..., :2]
    for k in ("cam_trans", "bbox_centres", "bbox_whs"):
        if k in data:
            out[k] = np.asarray(data[k], np.float32)
    if "fnames" in data:
        out["fnames"] = np.asarray([str(f) for f in data["fnames"]])
    if silhouette_dir is not None and "fnames" in out:
        sils = []
        for f in out["fnames"]:
            base = os.path.join(silhouette_dir, os.path.splitext(f)[0])
            if os.path.exists(base + ".npy"):
                sils.append(np.load(base + ".npy").astype(np.float32))
            elif os.path.exists(base + ".png"):
                sils.append((decode_png_grey(base + ".png") > 0).astype(np.float32))
            else:
                sils = None
                break
        if sils:
            out["silhouettes"] = np.stack(sils)
    return out


def load_3dpw(sequence_dir: str, split: str = "test", stride: int = 1) -> Dict[str, np.ndarray]:
    """3DPW sequence pickles, `<dir>/sequenceFiles/<split>/*.pkl` (or
    `<dir>/*.pkl`), read with `encoding='latin1'`: per actor its per-frame
    `poses` (F, 72) every `stride` frames, its `betas` (the first 10) and
    its gender.  Frames whose `campose_valid` is false are dropped."""
    paths = sorted(glob.glob(os.path.join(sequence_dir, "sequenceFiles", split, "*.pkl")))
    if not paths:
        paths = sorted(glob.glob(os.path.join(sequence_dir, "*.pkl")))
    if not paths:
        raise FileNotFoundError(f"no 3DPW sequence pkls under {sequence_dir}")
    poses, shapes, genders = [], [], []
    for p in paths:
        with open(p, "rb") as f:
            seq = pickle.load(f, encoding="latin1")
        n_actors = len(seq["poses"])
        for a in range(n_actors):
            pp = np.asarray(seq["poses"][a], np.float32)[::stride]
            if "campose_valid" in seq:
                pp = pp[np.asarray(seq["campose_valid"][a], bool)[::stride]]
            beta = np.asarray(seq["betas"][a], np.float32)[:10]
            g = normalise_gender(seq.get("genders", ["n"] * n_actors)[a])
            poses.append(pp)
            shapes.append(np.tile(beta, (len(pp), 1)))
            genders.append(np.asarray([g] * len(pp)))
    return {"poses": np.concatenate(poses), "shapes": np.concatenate(shapes),
            "genders": np.concatenate(genders)}


def load_eval_dataset(path: str) -> Dict[str, np.ndarray]:
    """A `--dataset` argument -> the canonical eval dict.  Accepts the
    SSP-3D release root (`labels.npz` + `silhouettes/`, the image-frame
    mIoU protocol's input), that `labels.npz` itself (a sibling
    `silhouettes/` is picked up), a 3DPW root (`sequenceFiles/` or
    `*.pkl`), or a canonical eval npz (aliased keys normalised)."""
    if os.path.isdir(path):
        labels = os.path.join(path, "labels.npz")
        if os.path.exists(labels):
            sil_dir = os.path.join(path, "silhouettes")
            return load_ssp3d(labels, sil_dir if os.path.isdir(sil_dir) else None)
        if (os.path.isdir(os.path.join(path, "sequenceFiles"))
                or glob.glob(os.path.join(path, "*.pkl"))):
            return load_3dpw(path)
        raise FileNotFoundError(f"{path}: no labels.npz or sequenceFiles/ inside")
    if os.path.basename(path) == "labels.npz":
        sil_dir = os.path.join(os.path.dirname(path), "silhouettes")
        return load_ssp3d(path, sil_dir if os.path.isdir(sil_dir) else None)
    data = dict(np.load(path, allow_pickle=True))
    if not (_first_key(data, _POSE_KEYS) and _first_key(data, _SHAPE_KEYS)):
        raise ValueError(f"eval npz needs poses/shapes; got {list(data)}")
    if "poses" in data and "shapes" in data:
        return data
    return load_ssp3d(path)
