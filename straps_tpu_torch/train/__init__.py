"""Synthetic training: the state, the batch, the steps and the loop
(counterpart of `straps_tpu/train/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.train.__all__` to its
counterparts here: every one has its own name.  `make_optimizer` gives
torch's Adam, the JAX package's optax one; `select_joint_sets` lives in
`smpl/model.py`.
"""

from straps_tpu_torch.smpl.model import select_joint_sets
from straps_tpu_torch.train.loop import build_training, train
from straps_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from straps_tpu_torch.train.step import make_train_step, make_val_step
from straps_tpu_torch.train.synthetic import (
    SyntheticBatch, build_proxy, generate_synthetic_batch,
)

__all__ = [
    "TrainState", "create_train_state", "make_optimizer", "SyntheticBatch",
    "generate_synthetic_batch", "select_joint_sets", "build_proxy", "make_train_step",
    "make_val_step", "train", "build_training",
]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
