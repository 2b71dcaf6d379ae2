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
or tensorstore: `_METADATA` (the tree's key paths and the layout), and
zarr v2 or zarr3 arrays, one per leaf, named by the dot-joined key path,
in an OCDBT database (`utils/ocdbt.py`) or a directory each, their chunks
zstd frames (`utils/zstd.py`); strings in `_strings.json`.
`restore_checkpoint` returns the tree as orbax's untyped restore does;
`load_checkpoint` of a directory returns the dict a `.pt` holds;
`save_orbax_checkpoint` writes the JAX package's tree (zarr v2 in
OCDBT, orbax's default), which its `restore_checkpoint` reads.
"""

import json
import os
import shutil
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from straps_tpu_torch.utils import ocdbt, zstd

# zarr v2 dtypes `write_tree` writes (`restore_checkpoint` reads more).
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


def load_checkpoint(path: str, task_order: Optional[Sequence[str]] = None,
                    resume: bool = False) -> Dict[str, Any]:
    """A checkpoint of `save_checkpoint`, its tensors on the CPU; or, for
    a directory, the JAX package's orbax checkpoint as the same dict
    (`checkpoint_from_tree`; `task_order` orders the loss log-variances
    in Adam's state).  For a `resume`, a directory whose training state
    holds bfloat16 leaves is refused by name: the JAX loop would go on
    training in bfloat16, and the port's `TrainState` is float32."""
    if os.path.isdir(path):
        tree = restore_checkpoint(path)
        if resume:
            low = [".".join(["state"] + [k for k, _ in keys])
                   for keys, leaf in _flatten(tree["state"])
                   if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16]
            if low:
                raise ValueError(
                    f"{path}: a resume from a bfloat16 training state is not supported "
                    f"({len(low)} bfloat16 leaves, e.g. {', '.join(low[:3])}): the JAX "
                    f"loop would go on training in bfloat16, the port's TrainState is "
                    f"float32")
        return checkpoint_from_tree(tree, task_order)
    return torch.load(path, map_location="cpu", weights_only=True)


# ----------------------------------------------------------------- reading
# The numpy dtype each zarr v2 dtype string and zarr3 data type is stored
# in.  numpy has no bfloat16: its 16 bits are read as uint16 and the leaf
# is returned as a torch.bfloat16 tensor.
_BF16 = np.dtype("<u2")
_V2_DTYPES = {s: np.dtype(s) for s in ("|b1", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2", "<u4",
                                       "<u8", "<f2", "<f4", "<f8")}
_V2_DTYPES["bfloat16"] = _BF16
_V3_DTYPES = {"bool": "|b1", "int8": "|i1", "int16": "<i2", "int32": "<i4", "int64": "<i8",
              "uint8": "|u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
              "float16": "<f2", "float32": "<f4", "float64": "<f8"}
_V3_DTYPES = {**{k: np.dtype(v) for k, v in _V3_DTYPES.items()}, "bfloat16": _BF16}
_ABSENT = (1 << 64) - 1         # a shard index entry of an inner chunk that was not written


class _Array:
    """One leaf's zarr metadata, read and checked: `shape`, `chunks` (the
    regular grid's chunk shape), storage `dtype`, whether it is `bfloat16`,
    the `fill` value (a 0-d array), `key(index)` (a chunk's key under the
    leaf) and `decode(raw)` (a chunk's bytes -> an array of `chunks`)."""

    def __init__(self, meta: dict, zarr3: bool, what: str):
        self.what = what
        (self._v3 if zarr3 else self._v2)(meta)

    def fail(self, why: str):
        raise ValueError(f"{self.what}: {why}")

    def _v2(self, meta):
        if meta.get("zarr_format") != 2:
            self.fail(f"zarr format {meta.get('zarr_format')} in .zarray (2 is read)")
        self._dtype(meta["dtype"], _V2_DTYPES, "dtype")
        compressor = (meta.get("compressor") or {}).get("id")
        if compressor not in ("zstd", None):
            self.fail(f"compressor {compressor!r} is not read (only zstd)")
        for key, want in (("order", "C"), ("filters", None)):
            if meta.get(key) != want:
                self.fail(f"{key} {meta.get(key)!r} is not read (only {want!r})")
        sep = meta.get("dimension_separator", ".")
        if sep not in (".", "/"):
            self.fail(f"dimension separator {sep!r} is not read")
        self.shape, self.chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        self.fill = self._fill(meta.get("fill_value"))
        self.key = lambda index: sep.join(map(str, index)) if index else "0"
        self.decode = lambda raw: self._bytes(zstd.decompress(raw, self._nbytes(self.chunks))
                                              if compressor else raw, self.chunks)

    def _v3(self, meta):
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            self.fail(f"zarr format {meta.get('zarr_format')}, node type "
                      f"{meta.get('node_type')!r} in zarr.json (a zarr3 array is read)")
        self._dtype(meta["data_type"], _V3_DTYPES, "data type")
        grid = meta.get("chunk_grid", {})
        if grid.get("name") != "regular":
            self.fail(f"chunk grid {grid.get('name')!r} is not read (only 'regular')")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(grid["configuration"]["chunk_shape"])
        self.fill = self._fill(meta.get("fill_value"))
        encoding = meta.get("chunk_key_encoding", {"name": "default"})
        sep = (encoding.get("configuration") or {}).get(
            "separator", "/" if encoding.get("name") == "default" else ".")
        if encoding.get("name") == "default":
            self.key = lambda index: sep.join(("c",) + tuple(map(str, index)))
        elif encoding.get("name") == "v2":
            self.key = lambda index: sep.join(map(str, index)) if index else "0"
        else:
            self.fail(f"chunk key encoding {encoding.get('name')!r} is not read")
        codecs = meta.get("codecs", [])
        self._check_codecs(codecs)
        self.decode = lambda raw: self._decode_v3(codecs, raw, self.chunks)

    def _dtype(self, name, table, what):
        if name not in table:
            self.fail(f"{what} {name!r} is not read (only {', '.join(table)})")
        self.dtype, self.bfloat16 = table[name], name == "bfloat16"

    def _fill(self, value) -> np.ndarray:
        """zarr's fill value: a number, a bool, "NaN" / "Infinity" /
        "-Infinity", or "0x..." (the raw bits); null reads as 0."""
        if value is None:
            return np.zeros((), self.dtype)
        if isinstance(value, str) and value.startswith("0x"):
            bits = np.array(int(value, 16), f"<u{self.dtype.itemsize}")
            return bits.view(self.dtype)
        if isinstance(value, str):
            named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
            if value not in named:
                self.fail(f"fill value {value!r} is not read")
            value = named[value]
        if self.bfloat16:
            bits = torch.tensor(float(value)).to(torch.bfloat16).view(torch.int16).item()
            return np.array(bits & 0xFFFF, self.dtype)
        return np.array(value, self.dtype)

    def _nbytes(self, shape) -> int:
        return int(np.prod(shape, dtype=np.int64)) * self.dtype.itemsize

    def _bytes(self, data, shape) -> np.ndarray:
        if len(data) != self._nbytes(shape):
            self.fail(f"a chunk holds {len(data)} bytes, not {self._nbytes(shape)}")
        return np.frombuffer(data, self.dtype).reshape(shape)

    def _check_codecs(self, codecs):
        """zarr3 codecs: an array-to-bytes codec (`bytes`, little-endian,
        or `sharding_indexed`, whose inner codecs are checked alike and
        whose index is `bytes` + optionally `crc32c`), then zstd."""
        names = [c.get("name") for c in codecs]
        for c, name in zip(codecs, names):
            if name not in ("bytes", "sharding_indexed", "zstd"):
                self.fail(f"codec {name!r} is not read (only bytes, sharding_indexed, zstd)")
            cfg = c.get("configuration") or {}
            if name == "bytes" and cfg.get("endian", "little") != "little":
                self.fail(f"endian {cfg.get('endian')!r} is not read (only little)")
            if name == "sharding_indexed":
                self._check_codecs(cfg.get("codecs", []))
                index = cfg.get("index_codecs", [])
                names_i = [i.get("name") for i in index]
                if names_i not in (["bytes"], ["bytes", "crc32c"]) or (
                        index[0].get("configuration") or {}).get("endian", "little") != "little":
                    self.fail(f"shard index codecs {names_i} are not read (little-endian "
                              f"bytes, then crc32c)")
                if cfg.get("index_location", "end") not in ("start", "end"):
                    self.fail(f"shard index location {cfg.get('index_location')!r}")
        if not names or names[0] not in ("bytes", "sharding_indexed") or any(
                n != "zstd" for n in names[1:]):
            self.fail(f"codecs {names} are not read (an array-to-bytes codec, then zstd)")

    def _decode_v3(self, codecs, raw, shape) -> np.ndarray:
        for _ in codecs[1:]:
            raw = zstd.decompress(raw, self._nbytes(shape))
        if codecs[0]["name"] == "bytes":
            return self._bytes(raw, shape)
        return self._shard(codecs[0]["configuration"], memoryview(raw).cast("B"), shape)

    def _shard(self, cfg, raw, shape) -> np.ndarray:
        """A `sharding_indexed` shard: its inner chunks through the index of
        (offset, nbytes) pairs, absent ones (all bits set) the fill value."""
        inner = tuple(cfg["chunk_shape"])
        if len(inner) != len(shape) or any(s % c for s, c in zip(shape, inner)):
            self.fail(f"inner chunk shape {list(inner)} does not divide the shard's "
                      f"{list(shape)}")
        grid = tuple(s // c for s, c in zip(shape, inner))
        n = int(np.prod(grid, dtype=np.int64))
        checked = len(cfg["index_codecs"]) == 2
        size = 16 * n + 4 * checked
        if len(raw) < size:
            self.fail(f"a shard of {len(raw)} bytes is shorter than its {size}-byte index")
        at = 0 if cfg.get("index_location", "end") == "start" else len(raw) - size
        index = raw[at:at + size]
        if checked and zstd.crc32c(index[:-4]) != struct.unpack("<I", index[-4:])[0]:
            self.fail("shard index CRC-32C mismatch")
        entries = np.frombuffer(index[:16 * n], "<u8").reshape(grid + (2,))
        out = np.empty(shape, self.dtype)
        for i in np.ndindex(*grid):
            dst = tuple(slice(a * c, (a + 1) * c) for a, c in zip(i, inner))
            offset, nbytes = (int(v) for v in entries[i])
            if offset == _ABSENT and nbytes == _ABSENT:
                out[dst] = self.fill
            elif offset + nbytes > len(raw):
                self.fail(f"inner chunk {list(i)} at [{offset}, {offset + nbytes}) lies past "
                          f"the shard's {len(raw)} bytes")
            else:
                out[dst] = self._decode_v3(cfg["codecs"], raw[offset:offset + nbytes], inner)
        return out


def _zarr_array(get, name: str, where: str, zarr3: bool, every_chunk: bool):
    """Leaf `name` through `get` (key -> bytes-like, KeyError when absent):
    its `.zarray` or `zarr.json`, then every chunk of the grid.  A chunk
    that is absent takes the fill value, unless the checkpoint says every
    chunk was written (`every_chunk`), when it is a fault.  A numpy array,
    or a torch.bfloat16 tensor for a bfloat16 leaf."""
    what = f"{where}: array {name}"
    meta_key = f"{name}/{'zarr.json' if zarr3 else '.zarray'}"
    try:
        meta = json.loads(bytes(get(meta_key)))
    except KeyError:
        raise ValueError(f"{what}: {meta_key} is missing") from None
    arr = _Array(meta, zarr3, what)
    shape, chunks = arr.shape, arr.chunks
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        arr.fail(f"chunk shape {list(chunks)} for shape {list(shape)}")
    out = np.empty(shape, arr.dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{arr.key(index)}"
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        try:
            raw = get(key)
        except KeyError:
            if every_chunk:
                arr.fail(f"chunk {key} is missing")
            out[dst] = arr.fill
            continue
        out[dst] = arr.decode(raw)[tuple(slice(0, d.stop - d.start) for d in dst)]
    if arr.bfloat16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _files(root: str):
    """A checkpoint directory without OCDBT as a key-value store: key
    `a/b` is the file `root/a/b`."""
    def get(key: str) -> bytes:
        parts = key.split("/")
        if key.startswith("/") or ".." in parts:
            raise ValueError(f"{root}: key {key!r} lies outside the checkpoint")
        try:
            with open(os.path.join(root, *parts), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            raise KeyError(key) from None
    return get


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
    lists, numpy arrays as leaves (0-d ones too), a torch.bfloat16 tensor
    for a bfloat16 leaf (its bits as stored), the Python int or float of a
    `scalar` leaf, the str of a `string` leaf (`_strings.json`), None where
    orbax saved None.  Every layout orbax's `PyTreeCheckpointHandler`
    writes: zarr v2 or zarr3 arrays, in one OCDBT database or a directory a
    leaf (named by the dot-joined key path).  Leaves decode on a thread a
    core.  Refused by name, naming the file and the cause: zarr v2
    compressors other than zstd, zarr3 codecs other than bytes,
    sharding_indexed and zstd, dtypes outside bool, int8-64, uint8-64,
    float16/32/64 and bfloat16, big-endian data, numbered OCDBT manifests,
    leaf types other than arrays, scalars, strings and None."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise ValueError(f"{path}: no _METADATA (not an orbax PyTree checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    zarr3 = bool(meta.get("use_zarr3", False))
    every_chunk = bool(meta.get("store_array_data_equal_to_fill_value", False))
    if meta.get("use_ocdbt", False):
        db = ocdbt.OcdbtReader(path)

        def get(key: str):
            return db.view(key.encode())
    else:
        get = _files(path)
    entries = list(meta["tree_metadata"].values())
    paths = [e["key_metadata"] for e in entries]
    strings_path = os.path.join(path, "_strings.json")
    strings = {}
    if any(e["value_metadata"]["value_type"] == "string" for e in entries):
        if not os.path.exists(strings_path):
            raise ValueError(f"{strings_path}: missing (the checkpoint has string leaves)")
        with open(strings_path) as f:
            strings = json.load(f)

    def leaf(entry):
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(k["key"] for k in entry["key_metadata"])
        if kind == "None":
            return None
        if kind == "string":
            if name not in strings:
                raise ValueError(f"{strings_path}: no string {name!r}")
            return str(strings[name])
        if kind not in _ARRAY_TYPES + ("scalar",):
            raise ValueError(f"{path}: leaf {name} of type {kind!r} is not read "
                             f"(arrays, scalars, strings and None only)")
        arr = _zarr_array(get, name, path, zarr3, every_chunk)
        if kind == "scalar":
            if arr.ndim:
                raise ValueError(f"{path}: scalar leaf {name} has shape {tuple(arr.shape)}")
            return arr.item()
        return arr

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        leaves = list(pool.map(leaf, entries))
    return _build_tree(paths, leaves)


def decode_meta_str(arr) -> str:
    """A string stored as uint8 bytes (or as a `string` leaf)."""
    if isinstance(arr, str):
        return arr
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
