"""The training state (counterpart of `straps_tpu/train/state.py`).

Everything the reference checkpoints: the regressor (parameters and
BatchNorm statistics), the learned loss log-variances, one Adam over both
together (`make_optimizer`), and the step count.  Over a data mesh the state is
a replica: every rank holds the same values, rank 0's at creation.
"""

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from straps_tpu_torch.models.regressor import SingleInputRegressor
from straps_tpu_torch.parallel.mesh import DataMesh, replicate


@dataclass
class TrainState:
    model: SingleInputRegressor
    log_vars: Dict[str, torch.Tensor]     # {task: scalar leaf tensor}
    optimizer: torch.optim.Adam
    step: int = 0
    mesh: Optional[DataMesh] = None       # the data mesh the state is replicated over
    # The update's CUDA graphs by batch shape (`train/step.py`); not saved.
    update_graphs: dict = field(default_factory=dict, repr=False)

    def state_dict(self) -> dict:
        """Tensors and plain containers only (`torch.load(weights_only=True)`
        reads it back)."""
        return {"model": self.model.state_dict(),
                "log_vars": {k: v.detach() for k, v in self.log_vars.items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore a `state_dict`; the learning rate stays this state's (the
        configured one), as the JAX loop's resume keeps `cfg.lr`."""
        self.model.load_state_dict(state["model"], strict=True)
        with torch.no_grad():
            for k, v in self.log_vars.items():
                v.copy_(state["log_vars"][k])
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        for g, lr in zip(self.optimizer.param_groups, lrs):
            g["lr"] = lr
        self.step = int(state["step"])

    def digest(self) -> str:
        """SHA-256 of every parameter, buffer and log-variance, in order:
        equal digests are bitwise-equal replicas."""
        h = hashlib.sha256()
        for t in (list(self.model.state_dict().values())
                  + [v.detach() for v in self.log_vars.values()]):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam with torch's defaults, as the JAX package's `optax.adam`
    (betas 0.9/0.999, eps 1e-8 outside the square root), over `params`."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: SingleInputRegressor, log_vars: Dict[str, torch.Tensor],
                       lr: float, mesh: Optional[DataMesh] = None) -> TrainState:
    """A fresh state: the model and log-variances as given, Adam at step 0
    over the model's parameters, then the log-variances.  With `mesh`, the
    model and log-variances are rank 0's (`replicate`), and the steps run
    over it."""
    if mesh is not None:
        replicate(model, mesh)
        replicate(log_vars, mesh)
    optimizer = make_optimizer(list(model.parameters()) + list(log_vars.values()), lr)
    return TrainState(model=model, log_vars=log_vars, optimizer=optimizer, mesh=mesh)
