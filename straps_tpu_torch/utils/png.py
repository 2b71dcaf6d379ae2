"""A minimal PNG writer (zlib + struct), so that the port writes its images
without an imaging package: 8-bit greyscale (H, W), RGB (H, W, 3) or RGBA
(H, W, 4), no interlace, every row with filter type 0."""

import os
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}    # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels) -> bytes:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> the bytes of a PNG file."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {a.dtype}")
    channels = 1 if a.ndim == 2 else (a.shape[2] if a.ndim == 3 else 0)
    if channels not in _COLOR_TYPES or 0 in a.shape:
        raise ValueError(f"PNG pixels must be (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels) -> None:
    """Write uint8 pixels to `path` as a PNG, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
