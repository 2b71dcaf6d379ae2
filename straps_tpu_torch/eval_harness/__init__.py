"""Offline evaluation: the dataset loaders and the runner (counterpart of
`straps_tpu/eval_harness/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.eval_harness.__all__` to
its counterparts here: every one has its own name.
"""

from straps_tpu_torch.eval_harness.datasets import load_3dpw, load_eval_dataset, load_ssp3d
from straps_tpu_torch.eval_harness.runner import (
    load_eval_npz, run_evaluation, synthesise_proxy_inputs,
)

__all__ = ["load_eval_npz", "load_eval_dataset", "run_evaluation", "synthesise_proxy_inputs",
           "load_ssp3d", "load_3dpw"]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
