"""Host IO through the port's native reader (`csrc/straps_io.cpp`, built
with g++ at first use): batched .npy reads, zero-copy .npy views and the
deterministic epoch shuffle.  Counterpart of `straps_tpu/data/native_io.py`
with the same entry points; a failed build raises.

`load_npy_batch` returns float32 whatever the files hold: float32 is
copied, and float64, integers and bool convert as numpy's
`astype(np.float32)` does, each file by its own header.
"""

import ctypes
import weakref
from typing import List, Sequence

import numpy as np

from straps_tpu_torch.utils.native_build import host_library

_MAX_DIMS = 8


class _NpyInfo(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("map_base", ctypes.c_void_p),
        ("map_len", ctypes.c_int64),
        ("num_elems", ctypes.c_int64),
        ("word_size", ctypes.c_int32),
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int64 * _MAX_DIMS),
        ("dtype_char", ctypes.c_char),
        ("byte_order", ctypes.c_char),
        ("fortran_order", ctypes.c_int32),
    ]


_SIGNATURES = {
    "si_open_npy": ([ctypes.c_char_p, ctypes.POINTER(_NpyInfo)], ctypes.c_int),
    "si_close_npy": ([ctypes.POINTER(_NpyInfo)], None),
    "si_load_batch_f32": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "si_shuffled_indices": ([ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)],
                            None),
}


def get_library():
    """The native reader's library, built at first use (`host_library`)."""
    return host_library("straps_io", _SIGNATURES)


_ERRORS = {-1: "not a .npy file", -2: "truncated header", -3: "unreadable header",
           -6: "data cut short", -10: "cannot open", -11: "cannot stat", -12: "cannot map",
           -20: "element count differs from the batch's", -21: "dtype not read"}


def load_npy_batch(paths: List[str], item_shape: Sequence[int], threads: int = 8) -> np.ndarray:
    """Load same-shaped .npy files into one (N, *item_shape) float32 array,
    read by `threads` native threads.

    Every file's header is checked against `item_shape` before any is read,
    so a transposed or mis-sized file raises ValueError naming it instead
    of being reinterpreted; a file the reader cannot read raises naming it
    too."""
    item_shape = tuple(item_shape)
    for p in paths:
        shape = np.load(p, mmap_mode="r").shape
        if tuple(shape) != item_shape:
            raise ValueError(f"{p}: shape {tuple(shape)} != expected {item_shape} "
                             f"(all files in a batch must share one shape)")
    out = np.empty((len(paths),) + item_shape, dtype=np.float32)
    if not paths:
        return out
    lib = get_library()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failed = ctypes.c_int64(-1)
    rc = lib.si_load_batch_f32(arr, len(paths),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               int(np.prod(item_shape, dtype=np.int64)), threads,
                               ctypes.byref(failed))
    if rc != 0:
        p = paths[failed.value]
        detail = _ERRORS.get(rc, f"error {rc}")
        if rc == -21:
            detail += f" ({np.load(p, mmap_mode='r').dtype.str})"
        raise ValueError(f"{p}: {detail}")
    return out


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """The deterministic epoch permutation of [0, n): the native xorshift64*
    Fisher-Yates of the JAX package's library (seed 0 takes the golden-ratio
    constant)."""
    out = np.empty(n, dtype=np.int64)
    get_library().si_shuffled_indices(n, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


_DTYPE_KINDS = {b"f": "f", b"i": "i", b"u": "u", b"b": "b"}


def mmap_npy(path: str) -> np.ndarray:
    """Zero-copy read-only view of an .npy file, memory-mapped by the
    native reader; the mapping closes when the last view of it goes."""
    lib = get_library()
    info = _NpyInfo()
    rc = lib.si_open_npy(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
    kind = _DTYPE_KINDS.get(info.dtype_char)
    if kind is None:
        lib.si_close_npy(ctypes.byref(info))
        raise ValueError(f"{path}: dtype kind {info.dtype_char!r} not read")
    order = info.byte_order.decode()
    dtype = np.dtype("bool" if kind == "b" else f"{order}{kind}{info.word_size}")
    shape = tuple(info.shape[i] for i in range(info.ndim))
    buf = (ctypes.c_char * max(info.num_elems * info.word_size, 1)).from_address(info.data)
    weakref.finalize(buf, lib.si_close_npy, ctypes.byref(info))
    arr = np.frombuffer(buf, dtype=dtype, count=info.num_elems).reshape(
        shape, order="F" if info.fortran_order else "C")
    arr.flags.writeable = False
    return arr
