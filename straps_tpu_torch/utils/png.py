"""A PNG writer and reader, so that the port reads and writes its images
without an imaging package.

The writer: 8-bit greyscale (H, W), RGB (H, W, 3) or RGBA (H, W, 4), no
interlace, every row with filter type 0.

The reader gives what `cv2.imread` gives (cv2 over libpng), bit for bit:
`decode_png` the colour read (`IMREAD_COLOR`, in RGB order) and
`decode_png_grey` the grey read (`IMREAD_GRAYSCALE`).  It reads every
colour type (grey, RGB, palette, grey + alpha, RGBA) at every bit depth
the format allows (1, 2, 4, 8, 16), interlaced (Adam7) or not, with the
image data over any number of IDAT chunks.  As libpng does for cv2:
16-bit samples become their high byte; grey samples of 1, 2 or 4 bits
are scaled to 8 (x255, x85, x17); palette indices past the palette are
black; alpha, tRNS and bKGD are dropped.  The grey read of a colour image
is libpng's `png_do_rgb_to_gray` with cv2's weights (0.299, 0.587): in
integers (9797 R + 19234 G + 3737 B) >> 15, with 16384 added before the
shift of 16-bit samples, unless the file declares a gamma other than 1
(a gAMA chunk, or an sRGB chunk, which stands for 1/2.2 whatever gAMA
says), when libpng weighs linear values through its gamma tables
(`_gamma_grey`).  sBIT changes only those 16-bit tables; iCCP, cICP and
cHRM change nothing.  What cv2 does not read raises a ValueError naming
the file: a bad signature, header or critical chunk (CRC included), a
palette image without PLTE, an unknown row filter, too little image data,
no IEND.  An ancillary chunk with a bad CRC is skipped, as libpng skips
it.

The rows are inflated with zlib and unfiltered by host C++
(`csrc/png_decode.cpp`, built with g++ at first use); unpacking,
deinterlacing and conversion are numpy.
"""

import ctypes
import functools
import math
import os
import struct
import zlib

import numpy as np

from straps_tpu_torch.utils.native_build import host_library

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


SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> (channels, allowed bit depths).
_COLOR_TYPE_FORMS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                     4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (row start, column start, row step, column step) of each pass.
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
# cv2's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) in libpng's 15-bit
# fixed point (blue takes the rest of 32768).
_RC, _GC, _BC = 9797, 19234, 3737
_FP1 = 100000                    # libpng's fixed-point 1.0
_SRGB_GAMMA = 45455              # PNG_GAMMA_sRGB_INVERSE


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = host_library("png_decode")
    lib.sp_png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.sp_png_unfilter.restype = ctypes.c_int64
    return lib


class _Image:
    """A PNG's samples before conversion: (h, w, channels) integers of
    `depth` bits, and what the conversions read from its chunks."""

    def __init__(self, samples, color_type, depth, palette, gamma, sbit):
        self.samples, self.color_type, self.depth = samples, color_type, depth
        self.palette, self.gamma, self.sbit = palette, gamma, sbit


def _chunks(data: bytes, name: str):
    """(tag, body) of each chunk up to IEND; critical chunks with a bad CRC
    and files that end before IEND raise, ancillary ones with a bad CRC are
    left out."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: PNG file ends before IEND")
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        if n > 0x7FFFFFFF or pos + 12 + n > len(data):
            raise ValueError(f"{name}: PNG file ends inside its {tag!r} chunk")
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        pos += 12 + n
        critical = not tag[0] & 0x20
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            if critical:
                raise ValueError(f"{name}: CRC error in the PNG {tag.decode(errors='replace')} "
                                 f"chunk")
            continue
        yield tag, body
        if tag == b"IEND":
            return


def _read(data: bytes, name: str) -> _Image:
    header, palette, gamma, srgb, sbit = None, None, None, False, None
    idat, after_idat = [], False
    for tag, body in _chunks(data, name):
        if header is None and tag != b"IHDR":
            raise ValueError(f"{name}: PNG chunk {tag!r} before IHDR")
        if tag == b"IDAT":
            if after_idat:
                raise ValueError(f"{name}: PNG IDAT chunks are not consecutive")
            idat.append(body)
            continue
        after_idat = bool(idat)
        if tag == b"IHDR":
            if header is not None or len(body) != 13:
                raise ValueError(f"{name}: bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IEND":
            break
        elif tag == b"PLTE" and not idat:
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f"{name}: bad PNG palette of {len(body)} bytes")
            palette = body
        elif not tag[0] & 0x20:
            raise ValueError(f"{name}: PNG chunk {tag!r} not read here")
        elif idat:
            continue                     # what follows the data changes nothing
        elif tag == b"gAMA" and gamma is None and len(body) == 4:
            # The first valid gAMA counts; a valid sRGB overrides it.
            if 16 <= struct.unpack(">I", body)[0] <= 625000000:
                gamma = struct.unpack(">I", body)[0]
        elif tag == b"sRGB":
            srgb = srgb or (len(body) == 1 and body[0] <= 3)
        elif tag == b"sBIT":
            sbit = body
    if header is None:
        raise ValueError(f"{name}: no PNG IHDR chunk")
    w, h, depth, color_type, compression, filtering, interlace = header
    form = _COLOR_TYPE_FORMS.get(color_type)
    if (form is None or depth not in form[1] or compression or filtering or interlace > 1
            or not 0 < w <= 0x7FFFFFFF or not 0 < h <= 0x7FFFFFFF):
        raise ValueError(f"{name}: PNG header not read (bit depth {depth}, colour type "
                         f"{color_type}, compression {compression}, filter {filtering}, "
                         f"interlace {interlace}, {w}x{h})")
    if color_type == 3 and palette is None:
        raise ValueError(f"{name}: PNG palette image without a PLTE chunk")
    if not idat:
        raise ValueError(f"{name}: PNG file without image data (IDAT)")
    channels = form[0]
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    shapes = [(-(-(h - r0) // dr), -(-(w - c0) // dc)) for r0, c0, dr, dc in passes]
    shapes = [(ph, pw) if ph > 0 and pw > 0 else (0, 0) for ph, pw in shapes]
    rowbytes = [-(-pw * bits // 8) for _, pw in shapes]
    need = sum(ph * (1 + rb) for (ph, _), rb in zip(shapes, rowbytes))
    try:
        inflater = zlib.decompressobj()
        raw = inflater.decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data: {e}") from None
    if len(raw) < need:
        raise ValueError(f"{name}: not enough PNG image data ({len(raw)} of {need} bytes)")
    rows = (ctypes.c_int32 * len(shapes))(*[ph for ph, _ in shapes])
    nbytes = (ctypes.c_int64 * len(shapes))(*rowbytes)
    out = np.empty(need - sum(ph for ph, _ in shapes), np.uint8)
    bad = _lib().sp_png_unfilter(raw, rows, nbytes, len(shapes), bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"{name}: unknown PNG row filter in row {bad}")
    samples = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for (r0, c0, dr, dc), (ph, pw), rb in zip(passes, shapes, rowbytes):
        if ph:
            block = out[at:at + ph * rb].reshape(ph, rb)
            samples[r0::dr, c0::dc] = _unpack(block, depth, pw * channels).reshape(
                ph, pw, channels)
            at += ph * rb
    if color_type == 3:
        palette = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
    if srgb:
        gamma = _SRGB_GAMMA
    return _Image(samples, color_type, depth, palette, gamma, sbit)


def _unpack(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(rows, rowbytes) bytes -> (rows, n) samples of `depth` bits."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        return (rows[:, :2 * n:2].astype(np.uint16) << 8) | rows[:, 1:2 * n:2]
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(len(rows), -1)[:, :n]


def _grey8(v: np.ndarray, depth: int) -> np.ndarray:
    """Grey samples as libpng gives them to cv2: 16 bits -> the high byte,
    1, 2 and 4 bits scaled to 8."""
    if depth == 16:
        return (v >> 8).astype(np.uint8)
    return (v * (255 // ((1 << depth) - 1))).astype(np.uint8)


def _significant(g: int) -> bool:
    return not _FP1 - 5000 <= g <= _FP1 + 5000


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + .5))


@functools.lru_cache(maxsize=None)
def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table: floor(255 (i/255)^(g/1e5) + .5) inside 1-254."""
    if not _significant(g):
        return np.arange(256, dtype=np.int64)
    return np.array([i if i in (0, 255) else int(math.floor(255 * math.pow(i / 255., g * 1e-5)
                                                            + .5)) for i in range(256)],
                    np.int64)


@functools.lru_cache(maxsize=None)
def _table16(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table, indexed by the top 16 - shift bits."""
    top = (1 << (16 - shift)) - 1
    ig = np.arange(top + 1, dtype=np.int64)
    if not _significant(g):
        return (ig * 65535 + (1 << (15 - shift))) // top
    fmax = 1.0 / top
    return np.array([int(math.floor(65535. * math.pow(int(x) * fmax, g * 1e-5) + .5))
                     for x in ig], np.int64)


def _gamma16(v: int, g: int) -> int:
    if 0 < v < 65535:
        return int(math.floor(65535 * math.pow(v / 65535., g * 1e-5) + .5))
    return v


@functools.lru_cache(maxsize=None)
def _table16to8(shift: int, g: int) -> np.ndarray:
    """png_build_16to8_table, indexed by the top 16 - shift bits."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        out = i * 257
        bound = (_gamma16(out + 128, g) * top + 32768) // 65535 + 1
        table[last:bound] = out
        last = max(last, min(bound, top + 1))
    return table


def _gamma_grey(rgb: np.ndarray, depth: int, gamma: int, sbit) -> np.ndarray:
    """png_do_rgb_to_gray with gamma tables, then the high byte: the file
    gamma `gamma` (fixed point) to linear, weighed, and back; a grey pixel
    (R = G = B) goes through the file-to-screen table instead.  cv2 asks
    for no screen gamma, so libpng takes the file's inverse."""
    screen = _reciprocal(gamma)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    grey = (r == g) & (r == b)
    if depth == 8:
        to1, from1 = _table8(_reciprocal(gamma)), _table8(_reciprocal(screen))
        same = _table8(int(math.floor(1e15 / gamma / screen + .5)))
        mixed = from1[(_RC * to1[r] + _GC * to1[g] + _BC * to1[b] + 16384) >> 15]
        return np.where(grey, same[r], mixed).astype(np.uint8)
    sig = max(sbit[:3]) if sbit is not None and len(sbit) >= 3 else 0
    shift = 16 - sig if 0 < sig < 16 else 0
    shift = min(max(shift, 5), 8)          # cv2 strips 16 bits to 8: 11 bits kept
    to1, from1 = _table16(shift, _reciprocal(gamma)), _table16(shift, _reciprocal(screen))
    same = _table16to8(shift, int(math.floor(gamma * 1e-5 * screen + .5)))
    mixed = (_RC * to1[r >> shift] + _GC * to1[g >> shift] + _BC * to1[b >> shift]
             + 16384) >> 15
    return (np.where(grey, same[r >> shift], from1[mixed >> shift]) >> 8).astype(np.uint8)


def _rgb(im: _Image) -> np.ndarray:
    """The image's RGB samples before any grey conversion (16 bits kept)."""
    if im.color_type == 3:
        return im.palette[im.samples[..., 0]]
    return im.samples[..., :3]


def decode_png_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_png` of the bytes of a PNG file; errors name `name`."""
    im = _read(data, name)
    if im.color_type in (0, 4):
        return np.repeat(_grey8(im.samples[..., :1], im.depth), 3, axis=2)
    rgb = _rgb(im)
    return np.ascontiguousarray(_grey8(rgb, im.depth) if im.depth == 16 else rgb)


def decode_png_grey_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode_png_grey` of the bytes of a PNG file; errors name `name`."""
    im = _read(data, name)
    if im.color_type in (0, 4):
        return np.ascontiguousarray(_grey8(im.samples[..., 0], im.depth))
    rgb = _rgb(im)
    depth = 8 if im.color_type == 3 else im.depth
    if im.gamma is not None and _significant(im.gamma):
        sbit = im.sbit if im.color_type != 3 else None
        return _gamma_grey(rgb, depth, im.gamma, sbit)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8).astype(np.uint8)
    return ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)


def decode_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W, 3) RGB: `cv2.imread(path,
    cv2.IMREAD_COLOR)[:, :, ::-1]`."""
    with open(path, "rb") as f:
        return decode_png_bytes(f.read(), path)


def decode_png_grey(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W): `cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`."""
    with open(path, "rb") as f:
        return decode_png_grey_bytes(f.read(), path)
