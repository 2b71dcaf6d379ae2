"""Zstandard frames without the zstandard package: `decompress` is
`zstandard.decompress` for every frame the JAX package's orbax checkpoints
hold (and any other frame without a dictionary), bit for bit; `frame_raw`
writes a frame of raw (stored) blocks, which every decoder reads; `crc32c`
is the CRC-32C that ends each OCDBT node.

The decoding is host C++ (`csrc/zstd_decode.cpp`, RFC 8878, built with g++
at first use): raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
streams) and treeless literals; predefined, RLE, FSE and repeat sequence
tables; skippable frames; several frames concatenated; the XXH64 content
checksum, verified.  A frame that needs a dictionary, and any malformed or
truncated input, raise a ValueError naming what was met; no partial output
is returned.  The decoder releases the GIL, so threads decode in parallel.
"""

import ctypes
import functools
import struct
import threading
from typing import Dict

import numpy as np

from straps_tpu_torch.utils.native_build import host_library

_ERR_LEN = 256
_BLOCK_MAX = 128 << 10          # the largest block a frame may hold
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


_SIGNATURES = {
    "sz_decompress": ([ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_char_p, ctypes.c_size_t], ctypes.c_void_p),
    "sz_data": ([ctypes.c_void_p], ctypes.c_void_p),
    "sz_size": ([ctypes.c_void_p], ctypes.c_size_t),
    "sz_free": ([ctypes.c_void_p], None),
    "sz_crc32c": ([ctypes.c_void_p, ctypes.c_size_t], ctypes.c_uint32),
    "sz_count_names": ([], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def count_names():
    """What `mode_counts` counts: frames, skippable frames, each block
    type, each literals type, Huffman streams of 1 and 4, each sequence
    table mode, verified checksums."""
    return tuple(host_library("zstd_decode", _SIGNATURES).sz_count_names().decode().split(","))


def _buffer(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data


def decompress(data, size_hint: int = 0) -> bytes:
    """Every frame of `data` (bytes-like) decoded and joined; ValueError
    naming the fault for input that is not a whole set of frames.
    `size_hint` (the expected size, if known) saves reallocation."""
    lib = host_library("zstd_decode", _SIGNATURES)
    buf = _buffer(data)
    names = count_names()
    counts = (ctypes.c_uint64 * len(names))()
    err = ctypes.create_string_buffer(_ERR_LEN)
    handle = lib.sz_decompress(buf.ctypes.data, buf.nbytes, size_hint, counts, err, _ERR_LEN)
    if not handle:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        out = ctypes.string_at(lib.sz_data(handle), lib.sz_size(handle))
    finally:
        lib.sz_free(handle)
    with _COUNTS_LOCK:
        for name, c in zip(names, counts):
            _COUNTS[name] = _COUNTS.get(name, 0) + int(c)
    return out


def mode_counts(reset: bool = False) -> Dict[str, int]:
    """The block, literals and sequence-table modes every `decompress` of
    this process met (`count_names`), optionally zeroed after reading."""
    with _COUNTS_LOCK:
        out = {name: _COUNTS.get(name, 0) for name in count_names()}
        if reset:
            _COUNTS.clear()
    return out


def frame_raw(data) -> bytes:
    """`data` as one zstd frame of raw blocks (single segment, content
    size written, no checksum)."""
    view = memoryview(_buffer(data)).cast("B")
    n = len(view)
    parts = [struct.pack("<IBQ", 0xFD2FB528, 0xE0, n)]
    starts = range(0, n, _BLOCK_MAX) if n else [0]
    for start in starts:
        block = view[start:start + _BLOCK_MAX]
        last = start + _BLOCK_MAX >= n
        parts.append(struct.pack("<I", (len(block) << 3) | int(last))[:3])
        parts.append(block)
    return b"".join(parts)


def crc32c(data) -> int:
    buf = _buffer(data)
    return int(host_library("zstd_decode", _SIGNATURES).sz_crc32c(buf.ctypes.data, buf.nbytes))
