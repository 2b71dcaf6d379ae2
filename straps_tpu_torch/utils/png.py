"""A minimal PNG writer and reader (zlib + struct), so that the port reads
and writes its images without an imaging package.  The writer: 8-bit
greyscale (H, W), RGB (H, W, 3) or RGBA (H, W, 4), no interlace, every row
with filter type 0.  The reader: 8-bit greyscale, greyscale + alpha, RGB
and RGBA, no interlace, all five row filters."""

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


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> channels


def _unfilter_row(ft: int, line: bytes, prev: bytearray, bpp: int) -> bytearray:
    """Undo one row's PNG filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    cur = bytearray(line)
    n = len(cur)
    if ft == 0:
        return cur
    if ft == 2:
        return bytearray((np.frombuffer(line, np.uint8) + np.frombuffer(bytes(prev), np.uint8))
                         .astype(np.uint8).tobytes())
    if ft == 1:
        return bytearray(np.cumsum(np.frombuffer(line, np.uint8).reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).tobytes())
    for i in range(n):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ft == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 255
        elif ft == 4:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter type {ft}")
    return cur


def decode_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG (greyscale, greyscale + alpha, RGB or RGBA, not
    interlaced, any of the five row filters) -> uint8 (H, W, 3) RGB: what
    `cv2.imread(path, cv2.IMREAD_COLOR)` gives, in RGB order (alpha
    dropped, greyscale replicated)."""
    with open(path, "rb") as f:
        return decode_png_bytes(f.read(), path)


def decode_png_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_png` of the bytes of a PNG file; errors name `name`."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{name}: only 8-bit non-interlaced greyscale, RGB and RGBA PNGs "
                         f"are read (bit depth {depth}, colour type {color}, interlace "
                         f"{interlace})")
    bpp = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    prev = bytearray(stride)
    rows = []
    for r in range(h):
        line = raw[r * (stride + 1):(r + 1) * (stride + 1)]
        prev = _unfilter_row(line[0], line[1:], prev, bpp)
        rows.append(bytes(prev))
    px = np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
