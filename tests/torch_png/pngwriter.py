"""A numpy PNG writer for the variants that Pillow and cv2 do not write:
every bit depth of every colour type, palettes with tRNS, Adam7
interlacing, image data split over several IDAT chunks, every row filter,
and ancillary chunks (gAMA, sBIT, iCCP, ...) placed before the data.

    png_bytes(samples, color_type, depth, palette=None, trns=None,
              interlace=0, chunks=(), idat_parts=1) -> bytes

`samples` is (h, w, channels) of integers below 2**depth (channels 1 for
colour types 0 and 3, 3 for 2, 2 for 4, 4 for 6).  Row r of each pass is
written with filter type r % 5, so every filter is exercised.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (row start, column start, row step, column step) of each pass.
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, rowbytes) uint8: big-endian 16-bit samples,
    sub-byte samples packed from the high bits, rows padded to a byte."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, 2 * w * c).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-w * c // per)
    padded = np.zeros((h, n * per), np.uint32)
    padded[:, :w * c] = flat
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint32)
    return (padded.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Each row prefixed with its filter type (row index % 5) and filtered."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, row in enumerate(rows.astype(np.int32)):
        ft = r % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = (0, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft))[ft]
        out.append(bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples, color_type: int, depth: int, palette=None, trns=None,
              interlace: int = 0, chunks=(), idat_parts: int = 1) -> bytes:
    """The bytes of a PNG file of `samples` (see the module docstring).
    `palette` is (n, 3) uint8 for colour type 3; `trns` the tRNS chunk's
    body; `chunks` (tag, body) pairs written after IHDR."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == CHANNELS[color_type], (c, color_type)
    assert samples.max(initial=0) < (1 << depth)
    bpp = max(1, c * depth // 8)
    if interlace:
        passes = [samples[r0::dr, c0::dc] for r0, c0, dr, dc in ADAM7]
        raw = b"".join(filter_rows(pack_rows(p, depth), bpp) for p in passes if p.size)
    else:
        raw = filter_rows(pack_rows(samples, depth), bpp)
    data = zlib.compress(raw, 9)
    cuts = np.linspace(0, len(data), idat_parts + 1).astype(int)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                                 interlace))
    for tag, body in chunks:
        out += chunk(tag, body)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += chunk(b"IDAT", data[a:b])
    return out + chunk(b"IEND", b"")
