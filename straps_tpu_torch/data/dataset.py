"""Synthetic-training dataset: npz of SMPL pose/shape params (a copy of
`straps_tpu/data/dataset.py`, numpy only).

The whole corpus (a few MB) lives in host memory as two numpy arrays; each
epoch is a shuffled index permutation from a `np.random.RandomState`, so the
batch order is the JAX loop's.
"""

from typing import Dict, Iterator

import numpy as np


class SyntheticTrainingDataset:
    """Loads npz with (fnames, poses (N,72), shapes (N,10)).

    `params_from` filters by source prefix exactly like the reference
    (`synthetic_training_dataset.py:19-38`): one of
    'all', 'h36m', 'up3d', '3dpw', 'not_amass'.
    """

    def __init__(self, npz_path: str, params_from: str = "all"):
        assert params_from in ("all", "h36m", "up3d", "3dpw", "not_amass")
        data = np.load(npz_path, allow_pickle=True)
        fnames = [str(f) for f in data["fnames"]]
        poses = np.asarray(data["poses"], dtype=np.float32)
        shapes = np.asarray(data["shapes"], dtype=np.float32)
        assert poses.shape[1:] == (72,), poses.shape
        assert shapes.shape[1:] == (10,), shapes.shape

        if params_from != "all":
            if params_from == "not_amass":
                keep = [i for i, f in enumerate(fnames)
                        if f.startswith(("h36m", "up3d", "3dpw"))]
            else:
                keep = [i for i, f in enumerate(fnames)
                        if f.startswith(params_from)]
            fnames = [fnames[i] for i in keep]
            poses = poses[keep]
            shapes = shapes[keep]

        self.fnames = fnames
        self.poses = poses
        self.shapes = shapes

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {"pose": self.poses[index], "shape": self.shapes[index]}


def epoch_batches(dataset: SyntheticTrainingDataset, batch_size: int,
                  rng: np.random.RandomState, shuffle: bool = True,
                  drop_last: bool = True, host_id: int = 0, num_hosts: int = 1
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield shuffled {pose (B,72), shape (B,10)} batches for one epoch.

    With `num_hosts > 1` each host sees a disjoint interleaved shard of the
    permutation, truncated to `n // num_hosts` samples so that every host
    yields as many batches as the others (a host with one batch more would
    enter a collective the others never match).
    """
    n = len(dataset)
    order = rng.permutation(n) if shuffle else np.arange(n)
    order = order[host_id::num_hosts]
    if num_hosts > 1:
        order = order[:n // num_hosts]
    num_full = len(order) // batch_size
    end = num_full * batch_size if drop_last else len(order)
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        yield {"pose": dataset.poses[idx], "shape": dataset.shapes[idx]}
