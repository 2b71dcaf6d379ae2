"""JPEG reading: `decode_jpeg(path)` is `cv2.imread(path)[:, :, ::-1]`
(an RGB uint8 (H, W, 3) array) for every JPEG that cv2 reads, equal bit for
bit to cv2 built with libjpeg-turbo 3.1, without cv2.

The decoding is host C++ (`csrc/jpeg_decode.cpp`, built with g++ at first
use).  It reads the DCT codings of 8-bit samples, Huffman or arithmetic:
baseline and extended sequential (SOF0, SOF1, SOF9) and progressive
(SOF2, SOF10), with restart intervals and any DAC conditioning; and
lossless Huffman frames (SOF3) of 2-8 bits, predictors 1-7 and any point
transform, whose samples are output as stored (shifted by the point
transform, not rescaled).  Greyscale (replicated to three channels),
three-component or four-component, every sampling factor libjpeg reads,
any size; libjpeg-turbo's ISLOW inverse DCT as its SIMD code computes it
(`idct_islow`), fancy upsampling and fixed-point YCbCr->RGB.  Four
components are read as cv2 reads them: CMYK as stored (Adobe transform 0,
as Pillow and Photoshop write it, or no Adobe marker) or YCCK (any other
transform) turned into CMYK by libjpeg's tables, then cv2's integer
CMYK->BGR conversion (R, G, B = k - ((255 - x) * k >> 8) for x = C, M, Y).
An APP1 Exif orientation of 2-8 is then applied as `cv2.imread` does.

A file cut short decodes as libjpeg does for cv2: Huffman data reads as
zero bits for the MCU in progress and the MCUs after it keep what they
have until a restart marker; arithmetic data reads as zero bytes to the
end of the scan; a marker segment cut short reads on into the EOI markers
libjpeg supplies; a progressive file whose coefficients 1-9 are left
incomplete is block-smoothed as libjpeg-turbo 3.1 smooths it.

Refused with a ValueError naming the file and the marker, as cv2.imread
reads no image from them: precisions other than 8 bits (2-8 lossless),
arithmetic-coded lossless (SOF11) and hierarchical (SOF5-SOF7,
SOF13-SOF15, DHP, EXP) frames, 2 components, and lossless greyscale or
YCbCr files (libjpeg-turbo converts no colours in lossless mode).
"""

import ctypes
import functools

import numpy as np

from straps_tpu_torch.utils.native_build import host_library

_ERR_LEN = 512


@functools.lru_cache(maxsize=None)
def _decoder() -> ctypes.CDLL:
    lib = host_library("jpeg_decode")
    lib.sj_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32]
    lib.sj_jpeg_decode.restype = ctypes.c_int
    lib.sj_free.argtypes = [ctypes.c_void_p]
    lib.sj_free.restype = None
    return lib


def apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The image as cv2.imread turns it for an Exif orientation tag: 1 (or
    none) as stored, 2 mirrored, 3 turned 180 degrees, 4 flipped, 5
    transposed, 6 turned 90 degrees clockwise, 7 transposed and turned
    180 degrees, 8 turned 90 degrees anticlockwise."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flips.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, axes) if axes else img)


def decode_jpeg_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of a JPEG file -> uint8 (H, W, 3) RGB, Exif orientation
    applied; ValueError naming `name` for what it does not read."""
    lib = _decoder()
    out = ctypes.c_void_p()
    h, w, orient = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.sj_jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(orient), err, _ERR_LEN)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    try:
        n = h.value * w.value * 3
        img = np.frombuffer(ctypes.string_at(out.value, n), np.uint8).reshape(h.value, w.value, 3)
    finally:
        lib.sj_free(out)
    return apply_exif_orientation(img, orient.value)


def decode_jpeg(path: str) -> np.ndarray:
    """`cv2.imread(path)[:, :, ::-1]` for a JPEG file: uint8 (H, W, 3) RGB."""
    with open(path, "rb") as f:
        return decode_jpeg_bytes(f.read(), path)
