"""Training corpora and host IO: the dataset, its epoch batches, the
seeded corpora, batched reads of cached .npy files (counterpart of
`straps_tpu/data/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.data.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.data.dataset import SyntheticTrainingDataset, epoch_batches
from straps_tpu_torch.data.fixtures import write_synthetic_corpus

__all__ = ["SyntheticTrainingDataset", "epoch_batches", "write_synthetic_corpus"]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
