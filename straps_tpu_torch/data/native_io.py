"""Batched .npy reads (counterpart of `load_npy_batch` in
`straps_tpu/data/native_io.py`), in numpy.  The JAX package's native
multithreaded reader is not ported yet."""

from typing import List, Sequence

import numpy as np


def load_npy_batch(paths: List[str], item_shape: Sequence[int]) -> np.ndarray:
    """Load same-shaped .npy files into one (N, *item_shape) float32 array.

    Every file's header is checked against `item_shape` before any is read,
    so a transposed or mis-sized file raises ValueError naming it instead
    of being reinterpreted."""
    item_shape = tuple(item_shape)
    for p in paths:
        shape = np.load(p, mmap_mode="r").shape
        if tuple(shape) != item_shape:
            raise ValueError(f"{p}: shape {tuple(shape)} != expected {item_shape} "
                             f"(all files in a batch must share one shape)")
    out = np.empty((len(paths),) + item_shape, dtype=np.float32)
    for i, p in enumerate(paths):
        out[i] = np.load(p)
    return out
