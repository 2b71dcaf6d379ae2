"""The training state (counterpart of `straps_tpu/train/state.py`).

Everything the reference checkpoints: the regressor (parameters and
BatchNorm statistics), the learned loss log-variances, one Adam over both
together (torch defaults: betas 0.9/0.999, eps 1e-8 outside the square
root, as `optax.adam`), and the step count.
"""

from dataclasses import dataclass
from typing import Dict

import torch

from straps_tpu_torch.models.regressor import SingleInputRegressor


@dataclass
class TrainState:
    model: SingleInputRegressor
    log_vars: Dict[str, torch.Tensor]     # {task: scalar leaf tensor}
    optimizer: torch.optim.Adam
    step: int = 0

    def state_dict(self) -> dict:
        """Tensors and plain containers only (`torch.load(weights_only=True)`
        reads it back)."""
        return {"model": self.model.state_dict(),
                "log_vars": {k: v.detach() for k, v in self.log_vars.items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        with torch.no_grad():
            for k, v in self.log_vars.items():
                v.copy_(state["log_vars"][k])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_train_state(model: SingleInputRegressor, log_vars: Dict[str, torch.Tensor],
                       lr: float) -> TrainState:
    """A fresh state: the model and log-variances as given, Adam at step 0
    over the model's parameters, then the log-variances."""
    optimizer = torch.optim.Adam(list(model.parameters()) + list(log_vars.values()),
                                 lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, log_vars=log_vars, optimizer=optimizer)
