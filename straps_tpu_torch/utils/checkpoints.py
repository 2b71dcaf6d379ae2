"""Training checkpoints (counterpart of `straps_tpu/utils/checkpoints.py`).

The port's own format is one `torch.save` file per saved epoch,
`<model_save_path>_epoch<N>.pt`, with the contents of the JAX package's
orbax checkpoint: the training state (model parameters and BatchNorm
statistics, loss log-variances, Adam state, step), `epoch`, `best_epoch`,
`best_params` (the parameters of the best validation epoch),
`best_epoch_val_metrics` and `meta.heatmap_mode` (the proxy heatmap
distribution the model was trained on).  Tensors and plain containers
only, so `torch.load(weights_only=True)` reads it.

The JAX package's checkpoints are orbax directories
(`<model_save_path>_epoch<N>`), read and written here without JAX, orbax
or tensorstore: `_METADATA` (the tree's key paths), and an OCDBT database
(`utils/ocdbt.py`) of zarr v2 arrays, one per leaf, named by the
dot-joined key path, their chunks zstd frames (`utils/zstd.py`).
`restore_checkpoint` returns the tree as orbax's untyped restore does;
`load_checkpoint` of a directory returns the dict a `.pt` holds;
`save_orbax_checkpoint` writes the JAX package's tree, which its
`restore_checkpoint` reads.
"""

import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from straps_tpu_torch.utils import ocdbt, zstd

# zarr v2 dtypes read and written; orbax writes bfloat16 leaves as
# "bfloat16", which is refused by name with every other dtype.
ZARR_DTYPES = ("<f4", "<f8", "<i4", "<i8", "|u1", "|b1")
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_KEY_DICT, _KEY_SEQUENCE = 2, 1
_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def checkpoint_path(model_save_path: str, epoch: int) -> str:
    return f"{model_save_path}_epoch{epoch}.pt"


def orbax_checkpoint_path(model_save_path: str, epoch: int) -> str:
    """Where the JAX package saves epoch `epoch` (a directory)."""
    return f"{model_save_path}_epoch{epoch}"


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


def load_checkpoint(path: str, task_order: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A checkpoint of `save_checkpoint`, its tensors on the CPU; or, for
    a directory, the JAX package's orbax checkpoint as the same dict
    (`checkpoint_from_tree`; `task_order` orders the loss log-variances
    in Adam's state)."""
    if os.path.isdir(path):
        return checkpoint_from_tree(restore_checkpoint(path), task_order)
    return torch.load(path, map_location="cpu", weights_only=True)


# ----------------------------------------------------------------- reading
def _zarr_array(db: ocdbt.OcdbtReader, name: str, where: str) -> np.ndarray:
    meta = json.loads(db.read(f"{name}/.zarray".encode()))
    what = f"{where}: array {name}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr format {meta.get('zarr_format')} (only 2 is read)")
    dtype = meta["dtype"]
    if dtype not in ZARR_DTYPES:
        raise ValueError(f"{what}: dtype {dtype!r} is not read (only {', '.join(ZARR_DTYPES)})")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor != "zstd":
        raise ValueError(f"{what}: compressor {compressor!r} is not read (only zstd)")
    for key, want in (("order", "C"), ("filters", None), ("fill_value", None)):
        if meta.get(key) != want:
            raise ValueError(f"{what}: {key} {meta.get(key)!r} is not read (only {want!r})")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{what}: dimension separator {sep!r} is not read (only '.')")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = np.dtype(dtype)
    out = np.empty(shape, dt)
    if out.size == 0:
        return out
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}".encode()
        try:
            raw = db.view(key)
        except KeyError:
            raise ValueError(f"{what}: chunk {key.decode()} is missing") from None
        data = zstd.decompress(raw, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{what}: chunk {key.decode()} holds {len(data)} bytes, "
                             f"not {chunk_bytes}")
        block = np.frombuffer(data, dt).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


class _Sequence(dict):
    """A node of sequence keys while the tree is built."""


def _build_tree(paths: List[List[dict]], leaves: List[Any]):
    """Nested dicts (key type 2) and lists (key type 1) from key paths."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for i, k in enumerate(path):
            key = int(k["key"]) if k["key_type"] == _KEY_SEQUENCE else k["key"]
            if i == len(path) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, _Sequence() if path[i + 1]["key_type"]
                                       == _KEY_SEQUENCE else {})

    def finish(node):
        if isinstance(node, _Sequence):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
            return [finish(node[i]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: finish(v) for k, v in node.items()}
        return node
    return finish(root)


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory as orbax's untyped
    `PyTreeCheckpointer().restore(path)` returns it: nested dicts and
    lists, numpy arrays as leaves (0-d for scalars), None where orbax
    saved None.  Chunks decode on a thread a core.
    Refused by name: zarr3 and non-OCDBT checkpoints, leaf types other
    than arrays and None, dtypes outside `ZARR_DTYPES` (bfloat16 among
    them), compressors other than zstd."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise ValueError(f"{path}: no _METADATA (not an orbax PyTree checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 checkpoints are not read (only zarr v2)")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: checkpoints without OCDBT are not read")
    db = ocdbt.OcdbtReader(path)
    entries = list(meta["tree_metadata"].values())
    paths = [e["key_metadata"] for e in entries]

    def leaf(entry):
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(k["key"] for k in entry["key_metadata"])
        if kind == "None":
            return None
        if kind not in _ARRAY_TYPES:
            raise ValueError(f"{path}: leaf {name} of type {kind!r} is not read "
                             f"(arrays and None only)")
        return _zarr_array(db, name, path)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        leaves = list(pool.map(leaf, entries))
    return _build_tree(paths, leaves)


def decode_meta_str(arr) -> str:
    return bytes(np.asarray(arr, np.uint8)).decode("utf-8")


def encode_meta_str(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8).copy()


def encoder_config(params: dict):
    """(resnet_layers, in_channels) of a flax regressor's parameters: the
    block family (a `conv3` is a bottleneck) and the blocks per stage name
    the depth; the stem's kernel its input channels."""
    from straps_tpu_torch.models.resnet import DEPTH_CONFIGS, Bottleneck

    enc = params["encoder"]
    blocks = [sum(1 for k in enc if k.startswith(f"layer{s}_")) for s in (1, 2, 3, 4)]
    bottleneck = "conv3" in enc["layer1_0"]
    for depth, (block, layers) in DEPTH_CONFIGS.items():
        if (block is Bottleneck) == bottleneck and tuple(layers) == tuple(blocks):
            return depth, int(enc["conv1"]["kernel"].shape[2])
    raise ValueError(f"no ResNet depth has {blocks} {'bottleneck' if bottleneck else 'basic'} "
                     f"blocks per stage")


def checkpoint_from_tree(tree: Dict[str, Any],
                         task_order: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A restored JAX training checkpoint -> the dict a `.pt` of
    `save_checkpoint` holds: the model's state dict (depth and input
    channels from the tree), the log-variances and Adam's moments and step
    (the log-variances after the model's parameters in `task_order`,
    default `TrainConfig.losses_on`'s order, then any others sorted; a
    resume passes its own), `epoch`, `best_epoch`, `best_params`,
    `best_epoch_val_metrics` and `meta.heatmap_mode`.  The JAX checkpoint
    records no learning rate: the param group holds `TrainConfig.lr`, and a
    resume keeps its configured one."""
    from straps_tpu_torch.config import TrainConfig
    from straps_tpu_torch.models.convert import (
        flax_to_torch_state_dict, state_dict_to_tensors, train_state_from_flax,
    )
    from straps_tpu_torch.models.regressor import build_regressor

    state = tree["state"]
    depth, in_channels = encoder_config(state["params"])
    model = build_regressor(np.zeros(144, np.float32), np.zeros(10, np.float32),
                            in_channels=in_channels, resnet_layers=depth)
    order = list(task_order or TrainConfig().losses_on)
    tasks = [t for t in order if t in state["log_vars"]]
    tasks += sorted(t for t in state["log_vars"] if t not in tasks)
    adam, = [s for s in state["opt_state"] if isinstance(s, dict) and "mu" in s and "nu" in s]
    tstate = train_state_from_flax(state["params"], state["batch_stats"],
                                   {t: state["log_vars"][t] for t in tasks}, model,
                                   TrainConfig().lr, device=torch.device("cpu"), opt_state=adam)
    tstate.step = int(state["step"])
    out = {
        "state": tstate.state_dict(),
        "epoch": int(tree["epoch"]),
        "best_epoch": int(tree["best_epoch"]),
        "best_params": state_dict_to_tensors(flax_to_torch_state_dict(
            {"params": tree["best_params"]})),
        "best_epoch_val_metrics": {k: float(v) for k, v in
                                   tree["best_epoch_val_metrics"].items()},
    }
    if "heatmap_mode" in tree.get("meta", {}):
        out["meta"] = {"heatmap_mode": decode_meta_str(tree["meta"]["heatmap_mode"])}
    return out


# ----------------------------------------------------------------- writing
def _flatten(tree, path=()):
    """(key path, leaf) pairs in JAX's order: dict keys sorted, sequences
    in order; a key is (name, key type)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + ((str(k), _KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ((str(i), _KEY_SEQUENCE),))
    else:
        yield path, tree


def write_tree(path: str, tree: Dict[str, Any]) -> None:
    """Write `tree` (nested dicts and lists of numpy arrays, or None) as an
    orbax PyTree checkpoint directory at `path`, replacing what is there:
    `_METADATA`, `_CHECKPOINT_METADATA`, and one OCDBT database of zarr v2
    arrays (one chunk each, zstd frames of raw blocks)."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    start = time.time_ns()
    items: Dict[bytes, Any] = {}
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        tree_meta[repr(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "None" if leaf is None else "np.ndarray",
                               "skip_deserialize": leaf is None}}
        if leaf is None:
            continue
        arr = np.asarray(leaf, order="C")         # (np.ascontiguousarray makes 0-d 1-d)
        if arr.dtype.str not in ZARR_DTYPES:
            raise ValueError(f"leaf {'.'.join(k for k, _ in keys)}: dtype {arr.dtype} is not "
                             f"written (only {', '.join(ZARR_DTYPES)})")
        name = ".".join(k for k, _ in keys)
        zarray = {"chunks": [max(d, 1) for d in arr.shape],
                  "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
                  "dtype": arr.dtype.str, "fill_value": None, "filters": None, "order": "C",
                  "shape": list(arr.shape), "zarr_format": 2}
        items[f"{name}/.zarray".encode()] = json.dumps(zarray, separators=(",", ":")).encode()
        if arr.size:
            chunk = ".".join("0" for _ in arr.shape) or "0"
            items[f"{name}/{chunk}".encode()] = zstd.frame_raw(arr.reshape(-1).view(np.uint8))
    ocdbt.write_database(tmp, items)
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_orbax_checkpoint(path: str, state, epoch: int, best_epoch: int,
                          best_params: Dict[str, torch.Tensor],
                          best_epoch_val_metrics: Dict[str, float],
                          heatmap_mode: Optional[str] = None) -> None:
    """`save_checkpoint`'s contents as the JAX package's orbax checkpoint
    directory (the tree of `straps_tpu.utils.checkpoints.save_checkpoint`:
    flax parameter names, the `TrainState` fields, optax Adam's state over
    `(params, log_vars)` as `[ScaleByAdamState, EmptyState]`), which the
    JAX package's `restore_checkpoint(path, template)` reads."""
    from straps_tpu_torch.models.convert import opt_state_to_optax, torch_state_dict_to_flax

    def host(t):
        return t.detach().cpu().numpy()

    variables = torch_state_dict_to_flax({k: host(v) for k, v in state.model.state_dict().items()})
    log_vars = {k: host(v).astype(np.float32) for k, v in state.log_vars.items()}
    tree = {
        "state": {"params": variables["params"], "batch_stats": variables["batch_stats"],
                  "log_vars": log_vars,
                  "opt_state": [opt_state_to_optax(state.optimizer, state.model, state.log_vars),
                                None],
                  "step": np.asarray(state.step, np.int32)},
        "epoch": np.asarray(epoch),
        "best_epoch": np.asarray(best_epoch),
        "best_params": torch_state_dict_to_flax({k: host(v) for k, v in
                                                 best_params.items()})["params"],
        "best_epoch_val_metrics": {k: np.asarray(float(v)) for k, v in
                                   best_epoch_val_metrics.items()},
    }
    if heatmap_mode is not None:
        tree["meta"] = {"heatmap_mode": encode_meta_str(heatmap_mode)}
    write_tree(path, tree)
