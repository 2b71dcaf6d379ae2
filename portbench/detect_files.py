"""What the detector reference reads from the files both sides are given:
detectron2 pickles (with `pickle`), the PNG photos (a plain zlib reader of
their unfiltered rows) and the JPEG photos (decoded by the library that
encoded them, cv2 or Pillow, whichever the machine has).  Kept beside
`reference/`, whose modules import only torch, numpy and math."""

import glob
import os
import pickle

import numpy as np
import torch

from portbench.drivers.predict_cached import read_png_rgb


def jpeg_library():
    """'cv2' or 'pillow', whichever is installed (cv2 first), or None."""
    for name, module in (("cv2", "cv2"), ("pillow", "PIL.Image")):
        try:
            __import__(module)
            return name
        except ImportError:
            continue
    return None


def encode_jpeg(path: str, rgb: np.ndarray, quality: int) -> str:
    """A baseline JPEG of uint8 RGB pixels, 4:2:0, at `quality`, written by
    `jpeg_library()`; returns the library's name."""
    lib = jpeg_library()
    if lib == "cv2":
        import cv2

        ok, data = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                                [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        if not ok:
            raise RuntimeError(f"cv2 could not encode {path}")
        with open(path, "wb") as f:
            f.write(data.tobytes())
    elif lib == "pillow":
        from PIL import Image

        Image.fromarray(np.ascontiguousarray(rgb)).save(path, "JPEG", quality=int(quality),
                                                         subsampling=2)
    else:
        raise RuntimeError("neither cv2 nor Pillow is installed: no JPEG encoder")
    return lib


def read_photo(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG written with unfiltered rows or of a JPEG."""
    if path.endswith(".png"):
        return read_png_rgb(path)
    if jpeg_library() == "cv2":
        import cv2

        return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1].copy()
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def photo_paths(root: str) -> list:
    """The folder's photos in the predict path's order (sorted full paths)."""
    return sorted(glob.glob(os.path.join(root, "*.png")) + glob.glob(os.path.join(root, "*.jpg")))


def read_d2_pkl(path: str, device) -> dict:
    """A detectron2 pickle -> {name: float32 tensor on `device`}."""
    with open(path, "rb") as f:
        state = pickle.load(f, encoding="latin1")
    state = state.get("model", state)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in state.items() if hasattr(v, "shape")}
