"""DensePose data structures: annotation container + flip symmetries
(the port's own copy of `straps_tpu/perception/densepose_structures.py`,
numpy only, with the same names, constants and semantics).

Rebuilds `DensePose/densepose/structures.py:10-183`:
  * `DensePoseTransformData` — horizontal-flip symmetry tables: the static
    mask/point label swaps plus the per-part (256, 256) UV lookup tables
    loaded from the dataset's `UV_symmetry_transforms.mat`
    (`structures.py:10-37`).  When the .mat asset is absent (licensing), a
    synthetic stand-in with the correct involution property is generated.
  * `DensePoseDataRelative` — per-instance annotation container with the
    same keys/validation (`structures.py:40-142`) and the vectorised
    horizontal-flip semantics (`structures.py:144-183`).
  * a first-party COCO RLE decoder (compressed LEB128-style counts and
    uncompressed lists) replacing the pycocotools C extension for the
    annotation masks (`structures.py:104`, SURVEY.md §2.4 #7).

Host-side numpy throughout — annotations are decoded once at data-loading
time; the device pipeline consumes dense arrays.
"""

from typing import Dict, List, Optional

import numpy as np

# Horizontal symmetry label transforms (structures.py:13-15).
MASK_LABEL_SYMMETRIES = (0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 14)
POINT_LABEL_SYMMETRIES = (0, 1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                          16, 15, 18, 17, 20, 19, 22, 21, 24, 23)
N_BODY_PARTS = 14
N_PART_LABELS = 24
MASK_SIZE = 256


def rle_decode(rle: Dict, height: Optional[int] = None,
               width: Optional[int] = None) -> np.ndarray:
    """Decode one COCO RLE segment to a binary (H, W) uint8 mask.

    Supports both compressed string counts (the pycocotools LEB128-style
    byte encoding with delta-coded runs) and uncompressed integer lists.
    Runs are column-major (Fortran order), like pycocotools.
    """
    h, w = rle.get("size", (height, width))
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        decoded: List[int] = []
        i = 0
        while i < len(counts):
            x = 0
            k = 0
            while True:
                c = counts[i] - 48
                i += 1
                x |= (c & 0x1F) << (5 * k)
                k += 1
                if not (c & 0x20):
                    if c & 0x10:
                        x |= -1 << (5 * k)
                    break
            if len(decoded) > 2:
                x += decoded[-2]
            decoded.append(x)
        counts = decoded
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    assert total == h * w, (total, h, w)
    vals = np.zeros(total, np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for j in range(1, len(counts), 2):      # odd runs are foreground
        vals[starts[j]:ends[j]] = 1
    return vals.reshape((w, h)).T           # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """Inverse of `rle_decode` (uncompressed counts), for tests/fixtures."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:                         # counts must start with a 0-run
        counts = [0] + counts
    return {"size": list(mask.shape), "counts": counts}


class DensePoseTransformData:
    """UV symmetry tables for horizontal flips (structures.py:10-37)."""

    def __init__(self, uv_symmetries: Dict[str, List[np.ndarray]]):
        self.mask_label_symmetries = list(MASK_LABEL_SYMMETRIES)
        self.point_label_symmetries = list(POINT_LABEL_SYMMETRIES)
        self.uv_symmetries = uv_symmetries

    @staticmethod
    def load(fpath: str) -> "DensePoseTransformData":
        """Load the dataset's `UV_symmetry_transforms.mat`."""
        import scipy.io
        m = scipy.io.loadmat(fpath)
        uv = {}
        for key in ("U_transforms", "V_transforms"):
            uv[key] = [np.asarray(m[key][0, i], np.float32)
                       for i in range(m[key].shape[1])]
        return DensePoseTransformData(uv)

    @staticmethod
    def synthetic() -> "DensePoseTransformData":
        """Stand-in tables when the .mat asset is absent: U mirrors
        (u -> 1-u), V passes through — an involution like the real tables,
        so flip-twice-is-identity holds and training code paths exercise the
        same LUT machinery."""
        u = np.linspace(0.0, 1.0, 256, dtype=np.float32)
        U = np.tile((1.0 - u)[None, :], (256, 1))      # [v, u] -> 1-u
        V = np.tile(np.linspace(0.0, 1.0, 256,
                                dtype=np.float32)[:, None], (1, 256))
        return DensePoseTransformData({
            "U_transforms": [U.copy() for _ in range(N_PART_LABELS)],
            "V_transforms": [V.copy() for _ in range(N_PART_LABELS)],
        })


def load_transform_data(fpath: Optional[str] = None) -> DensePoseTransformData:
    """Real tables when the .mat exists, synthetic stand-in otherwise."""
    import os
    if fpath is not None and os.path.exists(fpath):
        return DensePoseTransformData.load(fpath)
    return DensePoseTransformData.synthetic()


class DensePoseDataRelative:
    """Box-relative DensePose annotations (structures.py:40-142).

    Fields: x/y in [0, 256) box-normalised coords, i part labels 1..24,
    u/v chart coords in [0, 1], segm (256, 256) coarse mask with labels
    0..14.  `annotation` uses the COCO keys dp_x/dp_y/dp_I/dp_U/dp_V and
    dp_masks (list of 14 RLEs or binary masks).
    """

    X_KEY, Y_KEY, U_KEY, V_KEY, I_KEY, S_KEY = (
        "dp_x", "dp_y", "dp_U", "dp_V", "dp_I", "dp_masks")

    def __init__(self, annotation: Dict, cleanup: bool = False):
        ok, why = self.validate_annotation(annotation)
        assert ok, f"Invalid DensePose annotations: {why}"
        self.x = np.asarray(annotation[self.X_KEY], np.float32)
        self.y = np.asarray(annotation[self.Y_KEY], np.float32)
        self.i = np.asarray(annotation[self.I_KEY], np.int32)
        self.u = np.asarray(annotation[self.U_KEY], np.float32)
        self.v = np.asarray(annotation[self.V_KEY], np.float32)
        self.segm = self.extract_segmentation_mask(annotation)
        if cleanup:
            self.cleanup_annotation(annotation)

    @staticmethod
    def extract_segmentation_mask(annotation) -> np.ndarray:
        """14 per-part masks -> one (256, 256) labelled mask
        (structures.py:104-115); accepts RLE dicts or dense masks."""
        specs = annotation[DensePoseDataRelative.S_KEY]
        segm = np.zeros((MASK_SIZE, MASK_SIZE), np.float32)
        for i in range(N_BODY_PARTS):
            spec = specs[i]
            if spec is None or (hasattr(spec, "__len__") and len(spec) == 0):
                continue
            mask = (rle_decode(spec) if isinstance(spec, dict)
                    else np.asarray(spec))
            segm[mask > 0] = i + 1
        return segm

    @staticmethod
    def validate_annotation(annotation):
        for key in (DensePoseDataRelative.X_KEY, DensePoseDataRelative.Y_KEY,
                    DensePoseDataRelative.I_KEY, DensePoseDataRelative.U_KEY,
                    DensePoseDataRelative.V_KEY, DensePoseDataRelative.S_KEY):
            if key not in annotation:
                return False, f"no {key} data in the annotation"
        return True, None

    @staticmethod
    def cleanup_annotation(annotation):
        for key in (DensePoseDataRelative.X_KEY, DensePoseDataRelative.Y_KEY,
                    DensePoseDataRelative.I_KEY, DensePoseDataRelative.U_KEY,
                    DensePoseDataRelative.V_KEY, DensePoseDataRelative.S_KEY):
            annotation.pop(key, None)

    def apply_hflip(self, td: DensePoseTransformData) -> None:
        """Horizontal flip of points + segmentation (structures.py:144-183),
        vectorised: label swaps and UV remaps are LUT gathers instead of the
        reference's per-part python loop."""
        # points: mirror x, swap part labels, remap U/V via the part table.
        self.x = MASK_SIZE - self.x
        i_old = self.i.copy()
        point_lut = np.asarray(td.point_label_symmetries, np.int32)
        self.i = point_lut[i_old]
        u_loc = np.clip((self.u * 255).astype(np.int64), 0, 255)
        v_loc = np.clip((self.v * 255).astype(np.int64), 0, 255)
        U = np.stack(td.uv_symmetries["U_transforms"])   # (24, 256, 256)
        V = np.stack(td.uv_symmetries["V_transforms"])
        part = np.clip(i_old - 1, 0, N_PART_LABELS - 1)
        has_part = i_old > 0
        new_u = U[part, v_loc, u_loc]
        new_v = V[part, v_loc, u_loc]
        self.u = np.where(has_part, new_u, self.u).astype(np.float32)
        self.v = np.where(has_part, new_v, self.v).astype(np.float32)
        # segmentation: mirror + label symmetry.
        mask_lut = np.asarray(td.mask_label_symmetries, np.float32)
        self.segm = mask_lut[self.segm[:, ::-1].astype(np.int32)]
