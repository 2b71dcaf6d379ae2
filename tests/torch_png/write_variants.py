"""The committed PNG fixtures of the port's PNG reader tests: the variants
that cv2 and Pillow do not write (palette images with tRNS, 1-, 2- and
4-bit greyscale, 16-bit samples, Adam7 interlacing, several IDAT chunks,
gAMA, sRGB and sBIT chunks), written by `pngwriter.py` from seeded
samples.

    python tests/torch_png/write_variants.py

rewrites the fixtures `VARIANTS` of this directory and `expected.json`:
for each file its decoded shape and the SHA-256 of `cv2.imread(path)[:, :,
::-1]` (`sha256`) and of `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`
(`grey_sha256`).
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from pngwriter import CHANNELS, png_bytes  # noqa: E402


def samples(h: int, w: int, channels: int, depth: int, seed: int) -> np.ndarray:
    """Seeded (h, w, channels) samples of `depth` bits: gradients under a
    few flat rectangles, so that every row filter finds something to do,
    and grey pixels (equal channels) in the first rows."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (c + 1) + yy * (channels - c)) * top // max(2 * (h + w), 1)
                     for c in range(channels)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        base[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, top + 1, channels)
    noise = rng.integers(0, top + 1, base.shape)
    out = np.where(rng.random(base.shape[:2])[..., None] < 0.2, noise, base) % (top + 1)
    if channels >= 3:
        out[: h // 4, :, 1:3] = out[: h // 4, :, :1]
    return out


def palette(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    pal[: n // 4] = pal[: n // 4, :1]
    return pal


def _gama(v: int):
    return (b"gAMA", struct.pack(">I", v))


# name -> (size (h, w), colour type, bit depth, seed, options of png_bytes).
VARIANTS = {
    "palette8_trns.png": ((48, 64), 3, 8, 1, dict(trns=bytes(range(0, 250, 5)), idat_parts=3)),
    "palette2_adam7.png": ((37, 53), 3, 2, 2, dict(interlace=1)),
    "palette4_short.png": ((29, 31), 3, 4, 3, dict(palette_size=9)),
    "grey1.png": ((40, 61), 0, 1, 4, {}),
    "grey2_adam7.png": ((33, 47), 0, 2, 5, dict(interlace=1)),
    "grey4_trns.png": ((27, 35), 0, 4, 6, dict(trns=struct.pack(">H", 7))),
    "grey16.png": ((45, 39), 0, 16, 7, dict(chunks=[_gama(45455)])),
    "grey_alpha16_adam7.png": ((30, 44), 4, 16, 8, dict(interlace=1)),
    "rgb16_sbit.png": ((41, 50), 2, 16, 9, dict(chunks=[(b"sBIT", bytes([10, 11, 10]))])),
    "rgb16_gama_sbit.png": ((35, 42), 2, 16, 10, dict(chunks=[_gama(45455),
                                                           (b"sBIT", bytes([12, 12, 12]))])),
    "rgba16_adam7.png": ((38, 29), 6, 16, 11, dict(interlace=1, idat_parts=2)),
    "rgb8_gama.png": ((40, 40), 2, 8, 12, dict(chunks=[_gama(20000)])),
    "rgba8_srgb.png": ((36, 52), 6, 8, 13, dict(chunks=[(b"sRGB", b"\x00"), _gama(100000)])),
    "palette8_srgb_adam7.png": ((64, 64), 3, 8, 14, dict(interlace=1,
                                                         chunks=[(b"sRGB", b"\x01")])),
}


def variant_bytes(name: str) -> bytes:
    (h, w), color_type, depth, seed, options = VARIANTS[name]
    options = dict(options)
    pal = None
    if color_type == 3:
        pal = palette(options.pop("palette_size", 1 << depth), seed)
        px = samples(h, w, 1, depth, seed) % (1 << depth)
    else:
        px = samples(h, w, CHANNELS[color_type], depth, seed)
    return png_bytes(px, color_type, depth, palette=pal, **options)


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def cv2_entry(path: str) -> dict:
    """What expected.json holds for a file: cv2.imread's colour and grey
    reads."""
    import cv2
    colour = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return {"shape": list(colour.shape), "sha256": digest(colour), "grey_sha256": digest(grey)}


def write_fixtures(directory: str) -> dict:
    """Write `VARIANTS` into `directory`; returns what expected.json holds."""
    expected = {}
    for name in VARIANTS:
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(variant_bytes(name))
        expected[name] = cv2_entry(path)
    return expected


def main() -> int:
    expected = write_fixtures(HERE)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in VARIANTS)
    print(f"wrote {len(VARIANTS)} PNGs ({total} bytes) and expected.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
