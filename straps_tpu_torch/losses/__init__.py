"""Training losses (counterpart of `straps_tpu/losses/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.losses.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.losses.multi_task import ALL_TASKS, init_loss_log_vars, multi_task_loss

__all__ = ["multi_task_loss", "init_loss_log_vars", "ALL_TASKS"]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
