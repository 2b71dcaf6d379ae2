"""Training checkpoints (counterpart of `straps_tpu/utils/checkpoints.py`).

One `torch.save` file per saved epoch, `<model_save_path>_epoch<N>.pt`,
with the contents of the JAX package's orbax checkpoint: the training state
(model parameters and BatchNorm statistics, loss log-variances, Adam state,
step), `epoch`, `best_epoch`, `best_params` (the parameters of the best
validation epoch), `best_epoch_val_metrics` and `meta.heatmap_mode` (the
proxy heatmap distribution the model was trained on).  Tensors and plain
containers only, so `torch.load(weights_only=True)` reads it.
"""

import os
from typing import Any, Dict, Optional

import torch


def checkpoint_path(model_save_path: str, epoch: int) -> str:
    return f"{model_save_path}_epoch{epoch}.pt"


def save_checkpoint(path: str, state, epoch: int, best_epoch: int,
                    best_params: Dict[str, torch.Tensor],
                    best_epoch_val_metrics: Dict[str, float],
                    heatmap_mode: Optional[str] = None) -> None:
    """Write the checkpoint to `path` (through a temporary file, so a
    reader never sees half of it)."""
    payload = {
        "state": state.state_dict(),
        "epoch": int(epoch),
        "best_epoch": int(best_epoch),
        "best_params": dict(best_params),
        "best_epoch_val_metrics": {k: float(v) for k, v in best_epoch_val_metrics.items()},
    }
    if heatmap_mode is not None:
        payload["meta"] = {"heatmap_mode": heatmap_mode}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of `save_checkpoint`, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
