"""Writes JPEGs in the codings that cv2 and Pillow do not write, through
libjpeg-turbo's own compressor (`write_codings.c`): arithmetic-coded
sequential and progressive files (SOF9, SOF10), lossless files (SOF3) and
12-bit files (SOF1, SOF2).

The helper compiles with the system C compiler against the system's
`jpeglib.h` and links the libjpeg-turbo 3.x that Pillow bundles (found in
Pillow's package directory; it exports `jinit_arith_encoder`,
`jpeg_enable_lossless` and `jpeg12_write_scanlines`).

    python tests/torch_jpeg/write_codings.py

rewrites the committed fixtures `CODINGS` of this directory and their
entries of `expected.json` (the decoded shape and the SHA-256 of
`cv2.imread(path)[:, :, ::-1]`, or null where cv2 reads no image).
"""

import functools
import glob
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def pillow_libjpeg() -> str:
    """The libjpeg-turbo shared library that Pillow bundles."""
    import PIL
    found = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                          "pillow.libs", "libjpeg*.so*")))
    if not found:
        raise FileNotFoundError("Pillow bundles no libjpeg")
    return found[0]


@functools.lru_cache(maxsize=None)
def helper() -> str:
    """`write_codings.c` built once a process; returns the program's path."""
    lib = pillow_libjpeg()
    out_dir = tempfile.mkdtemp(prefix="write_codings_")
    exe = os.path.join(out_dir, "write_codings")
    subprocess.run([os.environ.get("CC", "cc"), "-O1", "-o", exe,
                    os.path.join(HERE, "write_codings.c"), lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True, capture_output=True)
    return exe


def write_jpeg(samples: np.ndarray, **options) -> bytes:
    """The bytes of a JPEG of `samples` ((h, w) or (h, w, 3) integers,
    RGB; uint16 for precisions above 8) written by libjpeg-turbo with
    `options` (write_codings.c's: precision, quality, arith, progressive,
    lossless=(psv, pt), sampling, cmyk, restart, dac=(L, U, K))."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    ncomp = 1 if samples.ndim == 2 else samples.shape[2]
    dtype = "<u2" if options.get("precision", 8) > 8 else np.uint8
    args = []
    for key, value in sorted(options.items()):
        if isinstance(value, (tuple, list)):
            value = ",".join(str(int(v)) for v in value)
        args.append(f"{key}={int(value) if isinstance(value, bool) else value}")
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        np.ascontiguousarray(samples.astype(dtype)).tofile(raw)
        proc = subprocess.run([helper(), raw, out, str(w), str(h), str(ncomp), *args],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"write_codings {' '.join(args)}: {proc.stderr.strip()}")
        with open(out, "rb") as f:
            return f.read()


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded photo-like RGB scene: a colour gradient, shapes with hard
    edges and soft shading, mild noise (`tests/test_torch_jpeg.py` writes
    its fixtures from it too)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / w * 200 + 30, yy / h * 160 + 60, (1 - xx / w) * 120 + yy / h * 80], -1)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, max(min(h, w) / 4, 8))
        col = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        else:
            m = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r * rng.uniform(0.3, 2))
        img[m] = col * (0.75 + 0.25 * np.cos(xx[m] / 9.0))[:, None]
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def grey(img: np.ndarray) -> np.ndarray:
    """An RGB scene's luma, as integers."""
    return (img.astype(np.int64) @ np.array([299, 587, 114]) // 1000).astype(np.uint8)


def coding_samples(name: str, h: int, w: int, seed: int, options: dict) -> np.ndarray:
    """The samples a fixture is written from: the scene (its luma for
    `grey` names, its luma as a fourth component for `cmyk` ones), scaled
    to the fixture's precision."""
    img = scene(h, w, seed)
    if "grey" in name:
        img = grey(img)
    elif "cmyk" in name:
        img = np.concatenate([img, grey(img)[..., None]], -1)
    precision = options.get("precision", 8)
    if precision > 8:
        return img.astype(np.uint16) << (precision - 8)
    return img >> (8 - precision)


# name -> ((h, w), seed, options, fraction of the file kept).  The last
# two are codings cv2 reads no image from.
CODINGS = {
    "arith_seq_420.jpg": ((452, 600), 21, dict(arith=1, quality=80, sampling=22), 1.0),
    "arith_seq_444_rst_dac.jpg": ((45, 61), 22, dict(arith=1, quality=75, sampling=11, restart=3,
                                                     dac=(2, 6, 9)), 1.0),
    "arith_prog_420.jpg": ((452, 600), 23, dict(arith=1, progressive=1, quality=80, sampling=22),
                           1.0),
    "arith_prog_444_rst.jpg": ((50, 37), 24, dict(arith=1, progressive=1, quality=70,
                                                  sampling=11, restart=2), 1.0),
    "arith_prog_420_cut.jpg": ((64, 48), 25, dict(arith=1, progressive=1, quality=80,
                                                  sampling=22), 0.5),
    "huff_prog_420_cut.jpg": ((64, 48), 26, dict(progressive=1, quality=80, sampling=22), 0.3),
    "lossless_p1.jpg": ((40, 52), 27, dict(lossless=(1, 0)), 1.0),
    "lossless_p7_pt2_rst.jpg": ((33, 47), 28, dict(lossless=(7, 2), restart=47), 1.0),
    "lossless_p4_cmyk.jpg": ((36, 29), 29, dict(lossless=(4, 0), cmyk=1), 1.0),
    "lossless_p5_6bit.jpg": ((31, 44), 30, dict(lossless=(5, 0), precision=6), 1.0),
    "lossless_p6_grey.jpg": ((26, 35), 31, dict(lossless=(6, 0)), 1.0),
    "grey_12bit.jpg": ((24, 32), 32, dict(precision=12, quality=90), 1.0),
}


def write_coding(name: str) -> bytes:
    (h, w), seed, options, keep = CODINGS[name]
    data = write_jpeg(coding_samples(name, h, w, seed, options), **options)
    return data[:int(len(data) * keep)] if keep < 1 else data


def cv2_digest(path: str):
    """What expected.json holds for a file: cv2.imread's shape and hash."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        return None
    px = np.ascontiguousarray(img[:, :, ::-1])
    return {"shape": list(px.shape), "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


def write_fixtures(directory: str) -> dict:
    """Write `CODINGS` into `directory`; returns their expected.json entries."""
    expected = {}
    for name in CODINGS:
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(write_coding(name))
        expected[name] = cv2_digest(path)
    return expected


def main() -> int:
    entries = write_fixtures(HERE)
    path = os.path.join(HERE, "expected.json")
    with open(path) as f:
        expected = json.load(f)
    expected.update(entries)
    with open(path, "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    for name, entry in entries.items():
        size = os.path.getsize(os.path.join(HERE, name))
        print(f"{name}: {size} bytes, cv2 {entry['shape'] if entry else 'reads no image'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
