"""Weights across frameworks: the JAX package's flax variables -> this
package's state dict or training state, and reference `.tar` checkpoints.

Counterpart of `straps_tpu/models/convert.py::flax_to_torch_state_dict`
(numpy only; it takes the flax variables as nested dicts of numpy arrays).
Layouts: conv HWIO -> OIHW, dense (in, out) -> (out, in).
"""

from typing import Dict, Optional

import numpy as np
import torch


def flax_to_torch_state_dict(variables: dict) -> Dict[str, np.ndarray]:
    """flax `{"params": ..., "batch_stats": ...}` of `SingleInputRegressor`
    -> reference-named numpy state dict that `SingleInputRegressor` of this
    package loads with `strict=True` (a zero `num_batches_tracked` is added
    for every BatchNorm)."""
    out: Dict[str, np.ndarray] = {}

    def torch_module(mods) -> str:
        if len(mods) == 1:
            return f"image_encoder.{mods[0]}"
        stage, block = mods[0].rsplit("_", 1)
        inner = {"downsample_conv": "downsample.0",
                 "downsample_bn": "downsample.1"}.get(mods[1], mods[1])
        return f"image_encoder.{stage}.{block}.{inner}"

    def leaf(coll, path, v):
        name = path[-1]
        if path[0] == "encoder":
            mod = torch_module(path[1:-1])
            if coll == "params":
                if name == "kernel":
                    out[f"{mod}.weight"] = v.transpose(3, 2, 0, 1)
                elif name == "scale":
                    out[f"{mod}.weight"] = v
                elif name == "bias":
                    out[f"{mod}.bias"] = v
            elif name == "mean":
                out[f"{mod}.running_mean"] = v
                out[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
            elif name == "var":
                out[f"{mod}.running_var"] = v
        elif path[0] == "ief":
            fc = path[1]
            if name == "kernel":
                out[f"ief_module.{fc}.weight"] = v.T
            elif name == "bias":
                out[f"ief_module.{fc}.bias"] = v

    def walk(coll, tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(coll, v, path + (k,))
            else:
                leaf(coll, path + (k,), np.ascontiguousarray(np.asarray(v)))

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(coll, variables[coll], ())
    return out


def state_dict_to_tensors(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def load_reference_checkpoint(path: str, key: str = "best_model_state_dict"
                              ) -> Dict[str, torch.Tensor]:
    """The regressor state dict of a reference-format `.tar` checkpoint
    (a `torch.save` dict holding `best_model_state_dict`), on the CPU.
    Loaded with `weights_only=True`: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt[key] if key in ckpt else ckpt
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def train_state_from_flax(params: dict, batch_stats: dict, log_vars: Dict[str, object],
                          model, lr: float, device: Optional[torch.device] = None):
    """The JAX package's training state (flax `params` and `batch_stats`,
    the `log_vars` dict of scalars) -> this package's `TrainState`: the
    weights and BatchNorm statistics loaded into `model` (strict), the
    log-variances as float32 leaf tensors, a fresh Adam at step 0."""
    # Imported here: the rest of this module, which the predict path loads
    # weights through, stays below the training layer.
    from straps_tpu_torch.train.state import create_train_state

    device = device or next(model.parameters()).device
    sd = flax_to_torch_state_dict({"params": params, "batch_stats": batch_stats})
    model.load_state_dict(state_dict_to_tensors(sd), strict=True)
    model.to(device)
    lv = {k: torch.tensor(np.float32(np.asarray(v)), device=device, requires_grad=True)
          for k, v in log_vars.items()}
    return create_train_state(model, lv, lr)
