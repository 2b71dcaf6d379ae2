"""Tiny synthetic pose/shape corpora for tests and smoke runs (a copy of
`straps_tpu/data/fixtures.py`; the real AMASS/UP3D/3DPW npz files are not
redistributable)."""

import os

import numpy as np


def write_synthetic_corpus(path: str, n: int = 64, seed: int = 0) -> str:
    """Write an npz with the exact reference schema (fnames, poses, shapes).

    Poses are small random axis-angle vectors (plausible joint ranges);
    fnames carry mixed source prefixes so `params_from` filtering is
    exercisable.
    """
    rng = np.random.RandomState(seed)
    prefixes = ["amass", "h36m", "up3d", "3dpw"]
    fnames = np.array([f"{prefixes[i % 4]}_{i:05d}.npz" for i in range(n)])
    poses = (rng.randn(n, 72) * 0.25).astype(np.float32)
    poses[:, :3] = rng.randn(n, 3).astype(np.float32) * 0.1  # mild root rot
    shapes = (rng.randn(n, 10) * 0.8).astype(np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, fnames=fnames, poses=poses, shapes=shapes)
    return path
