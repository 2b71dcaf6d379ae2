"""Weights across frameworks: the JAX package's flax variables and optax
Adam state <-> this package's state dict or training state, and reference
`.tar` checkpoints.

Counterpart of `straps_tpu/models/convert.py` (numpy only: flax variables
are nested dicts of numpy arrays; a bfloat16 leaf, a torch.bfloat16
tensor, is widened to float32).  Layouts: conv HWIO <-> OIHW (a
grouped kernel's (kh, kw, in/groups, out) <-> (out, in/groups, kh, kw)),
dense (in, out) <-> (out, in).
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def host_array(v) -> np.ndarray:
    """A leaf of a restored flax tree as a numpy array: a torch.bfloat16
    tensor (an orbax checkpoint's bfloat16 leaf) widened to float32
    exactly, as flax promotes a bfloat16 parameter against float32."""
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
    return np.asarray(v)


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
                leaf(coll, path + (k,), np.ascontiguousarray(host_array(v)))

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(coll, variables[coll], ())
    return out


def bfloat16_variance_layers(variables: dict) -> Dict[str, str]:
    """{module name, in `flax_to_torch_state_dict`'s naming: "root" or
    "sum"} of the BatchNorm layers of flax `{"params", "batch_stats"}`
    whose running variance is bfloat16 (a torch.bfloat16 tensor): flax
    computes their `rsqrt(var + eps)` in bfloat16, rounding the root too
    when the scale is bfloat16 ("root")
    (`models/resnet.py::BatchNorm2d.bfloat16_variance`)."""
    def low(v):
        return isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16

    def flags(stats, params):
        return {k: flags(v, params.get(k, {})) if isinstance(v, dict) else
                np.asarray(2 if low(v) and low(params.get("scale")) else int(low(v)))
                for k, v in stats.items()}
    marked = flax_to_torch_state_dict(
        {"batch_stats": flags(variables["batch_stats"], variables.get("params", {}))})
    return {k[:-len(".running_var")]: "root" if v.item() == 2 else "sum"
            for k, v in marked.items() if k.endswith(".running_var") and v.item()}


def torch_state_dict_to_flax(state: Mapping[str, np.ndarray]) -> dict:
    """Inverse of `flax_to_torch_state_dict`: a reference-named state dict
    (numpy values) -> flax `{"params": ..., "batch_stats": ...}` of the JAX
    package's `SingleInputRegressor` (scopes `encoder` / `ief`), so that
    weights trained by this package load into the JAX model.
    `num_batches_tracked` is dropped (flax keeps no such count)."""
    params: dict = {}
    batch_stats: dict = {}

    def set_in(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for key, value in state.items():
        v = np.asarray(value)
        parts = key.split(".")
        if parts[0] == "image_encoder":
            rest = parts[1:]
            if rest[0].startswith("layer"):
                stage, block, sub = rest[0], rest[1], rest[2:]
                scope = (f"{stage}_{block}",)
                if sub[0] == "downsample":
                    mod = "downsample_conv" if sub[1] == "0" else "downsample_bn"
                    leaf = sub[2]
                else:
                    mod, leaf = sub[0], sub[1]
            else:
                scope, mod, leaf = (), rest[0], rest[1]
            path = ("encoder",) + scope + (mod,)
            if leaf == "weight":
                if v.ndim == 4:
                    set_in(params, path + ("kernel",), v.transpose(2, 3, 1, 0))
                else:
                    set_in(params, path + ("scale",), v)
            elif leaf == "bias":
                set_in(params, path + ("bias",), v)
            elif leaf == "running_mean":
                set_in(batch_stats, path + ("mean",), v)
            elif leaf == "running_var":
                set_in(batch_stats, path + ("var",), v)
        elif parts[0] == "ief_module" and parts[1].startswith("fc"):
            path = ("ief", parts[1])
            if parts[2] == "weight":
                set_in(params, path + ("kernel",), v.T)
            elif parts[2] == "bias":
                set_in(params, path + ("bias",), v)
    return {"params": params, "batch_stats": batch_stats}


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


def opt_state_from_optax(adam: Mapping[str, object], model, log_vars: Mapping[str, object]
                         ) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax Adam's state over `(params, log_vars)` -> the per-parameter
    `state` of a `torch.optim.Adam` over the model's parameters, then the
    log-variances (`create_train_state`'s order).

    `adam` holds the `ScaleByAdamState` fields as numpy: `count` (the
    updates taken) and the moments `mu` and `nu`, each a `(flax params,
    {task: scalar})` pair.  optax's `count` is torch's `step`: both bias
    corrections use it after the increment, so the resumed run continues
    the JAX run's Adam trajectory."""
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    moments = []
    for name in ("mu", "nu"):
        tree, lv = adam[name]
        sd = flax_to_torch_state_dict({"params": tree})
        moments.append([sd[k] for k, _ in model.named_parameters()]
                       + [host_array(lv[k]) for k in log_vars])
    return {i: {"step": step.clone(),
                "exp_avg": torch.tensor(np.float32(m)),
                "exp_avg_sq": torch.tensor(np.float32(v))}
            for i, (m, v) in enumerate(zip(*moments))}


def opt_state_to_optax(optimizer, model, log_vars: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of `opt_state_from_optax`: a `torch.optim.Adam` over the
    model's parameters, then the log-variances -> optax Adam's
    `ScaleByAdamState` as numpy `{count (int32), mu, nu}`, each moment a
    `[flax params, {task: scalar}]` pair (zeros before the first step)."""
    state = optimizer.state_dict()["state"]
    named = [k for k, _ in model.named_parameters()]
    params = list(model.parameters()) + list(log_vars.values())
    step = 0
    moments = {"mu": [], "nu": []}
    for i, p in enumerate(params):
        s = state.get(i, {})
        step = int(float(s["step"])) if "step" in s else step
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            v = s.get(key)
            moments[name].append(np.zeros(tuple(p.shape), np.float32) if v is None
                                 else v.detach().cpu().numpy().astype(np.float32))
    out = {"count": np.asarray(step, np.int32)}
    for name, values in moments.items():
        tree = torch_state_dict_to_flax(dict(zip(named, values[:len(named)])))["params"]
        out[name] = [tree, {k: v.reshape(()) for k, v in zip(log_vars, values[len(named):])}]
    return out


def train_state_from_flax(params: dict, batch_stats: dict, log_vars: Dict[str, object],
                          model, lr: float, device: Optional[torch.device] = None,
                          opt_state: Optional[Mapping[str, object]] = None):
    """The JAX package's training state (flax `params` and `batch_stats`,
    the `log_vars` dict of scalars, optionally optax Adam's state as
    `opt_state_from_optax` takes it) -> this package's `TrainState`: the
    weights and BatchNorm statistics loaded into `model` (strict), the
    log-variances as float32 leaf tensors, and Adam with the JAX run's
    moments and step count (without `opt_state`, a fresh Adam at step 0)."""
    # Imported here: the rest of this module, which the predict path loads
    # weights through, stays below the training layer.
    from straps_tpu_torch.train.state import create_train_state

    device = device or next(model.parameters()).device
    sd = flax_to_torch_state_dict({"params": params, "batch_stats": batch_stats})
    model.load_state_dict(state_dict_to_tensors(sd), strict=True)
    model.to(device)
    lv = {k: torch.tensor(np.float32(host_array(v)), device=device, requires_grad=True)
          for k, v in log_vars.items()}
    state = create_train_state(model, lv, lr)
    if opt_state is not None:
        groups = state.optimizer.state_dict()["param_groups"]
        state.optimizer.load_state_dict(
            {"state": opt_state_from_optax(opt_state, model, lv), "param_groups": groups})
        state.step = int(np.asarray(opt_state["count"]))
    return state
