#!/usr/bin/env python3
"""Rewrite an orbax checkpoint directory into another layout that orbax's
`PyTreeCheckpointHandler` writes, without JAX, orbax or tensorstore:

    python tests/torch_orbax/relayout.py SRC DST [--zarr3] [--no-ocdbt] [--bfloat16]

The tree is read with the port's `restore_checkpoint` and written back as
zarr v2 (`.zarray`, one zstd frame a leaf) or zarr3 (`zarr.json`, a
`sharding_indexed` shard a leaf: the inner chunk a zstd frame, then the
(offset, nbytes) index and its CRC-32C), in one OCDBT database or in a
directory a leaf, with the `_METADATA` orbax writes for those options.
`--bfloat16` stores the parameters, BatchNorm statistics and Adam moments
of a training checkpoint (`BFLOAT16_LEAVES`) as bfloat16, rounded to
nearest even as `astype(jnp.bfloat16)` rounds (`cast_bfloat16`).  Leaves:
arrays, bfloat16 tensors and None.

`leaf_digests` gives the SHA-256, dtype and shape of every leaf of a
restored tree (numpy arrays, bfloat16 tensors or ml_dtypes arrays,
scalars, strings), the digests `layouts.json` holds.
"""

import argparse
import hashlib
import json
import os
import shutil
import struct
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402

from straps_tpu_torch.utils import ocdbt, zstd                # noqa: E402
from straps_tpu_torch.utils.checkpoints import _HANDLER, _flatten, restore_checkpoint  # noqa: E402

# Subtrees of a training checkpoint that `--bfloat16` casts.
BFLOAT16_LEAVES = ("state.params.", "state.batch_stats.", "state.opt_state.0.mu.",
                   "state.opt_state.0.nu.", "best_params.")
_V3_TYPES = {"|b1": "bool", "|i1": "int8", "<i2": "int16", "<i4": "int32", "<i8": "int64",
             "|u1": "uint8", "<u2": "uint16", "<u4": "uint32", "<u8": "uint64",
             "<f2": "float16", "<f4": "float32", "<f8": "float64"}


def cast_bfloat16(tree, prefixes=BFLOAT16_LEAVES, name: str = ""):
    """`tree` with its floating leaves whose dotted key path starts with
    one of `prefixes` as torch.bfloat16 tensors, rounded to nearest even."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: cast_bfloat16(v, prefixes, f"{name}{k}.") for k, v in items}
        return out if isinstance(tree, dict) else [out[i] for i in range(len(tree))]
    if tree is not None and name.startswith(tuple(prefixes)) and np.asarray(tree).dtype.kind == "f":
        return torch.from_numpy(np.array(tree, np.float32, order="C")).to(torch.bfloat16)
    return tree


def _storage(leaf):
    """(C-ordered array, zarr v2 dtype, zarr3 data type) of a leaf."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return leaf.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16", "bfloat16"
    arr = np.asarray(leaf, order="C")
    if arr.dtype.str not in _V3_TYPES:
        raise ValueError(f"dtype {arr.dtype} is not written")
    return arr, arr.dtype.str, _V3_TYPES[arr.dtype.str]


def _v2_items(name, arr, dtype):
    zarray = {"chunks": [max(d, 1) for d in arr.shape],
              "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
              "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
              "shape": list(arr.shape), "zarr_format": 2}
    chunk = ".".join("0" for _ in arr.shape) or "0"
    return {f"{name}/.zarray": json.dumps(zarray, separators=(",", ":")).encode(),
            f"{name}/{chunk}": zstd.frame_raw(arr.reshape(-1).view(np.uint8))}


def _v3_items(name, arr, data_type):
    fill = False if data_type == "bool" else 0.0 if data_type.startswith(("float", "bfloat")) \
        else 0
    little = {"name": "bytes", "configuration": {"endian": "little"}}
    shape = list(arr.shape)
    meta = {"chunk_grid": {"configuration": {"chunk_shape": shape}, "name": "regular"},
            "chunk_key_encoding": {"name": "default"},
            "codecs": [{"configuration": {
                "chunk_shape": shape,
                "codecs": [little, {"configuration": {"checksum": False, "level": 3},
                                    "name": "zstd"}],
                "index_codecs": [little, {"name": "crc32c"}]}, "name": "sharding_indexed"}],
            "data_type": data_type, "fill_value": fill, "node_type": "array",
            "shape": shape, "zarr_format": 3}
    frame = zstd.frame_raw(arr.reshape(-1).view(np.uint8))
    index = struct.pack("<QQ", 0, len(frame))
    shard = frame + index + struct.pack("<I", zstd.crc32c(index))
    return {f"{name}/zarr.json": json.dumps(meta, separators=(",", ":")).encode(),
            "/".join([name, "c"] + ["0"] * arr.ndim): shard}


def write_layout(path: str, tree, zarr3: bool, use_ocdbt: bool) -> None:
    """Write `tree` (nested dicts and lists of arrays, bfloat16 tensors or
    None) at `path` in the given layout, replacing what is there."""
    path = os.path.abspath(path)
    tmp = f"{path}.relayout-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    start = time.time_ns()
    items, tree_meta = {}, {}
    for keys, leaf in _flatten(tree):
        name = ".".join(k for k, _ in keys)
        tree_meta[repr(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "None" if leaf is None else "np.ndarray",
                               "skip_deserialize": leaf is None}}
        if leaf is None:
            continue
        arr, v2_dtype, v3_type = _storage(leaf)
        items.update(_v3_items(name, arr, v3_type) if zarr3 else _v2_items(name, arr, v2_dtype))
    if use_ocdbt:
        ocdbt.write_database(tmp, {k.encode(): v for k, v in items.items()})
    else:
        for key, value in items.items():
            os.makedirs(os.path.dirname(os.path.join(tmp, key)), exist_ok=True)
            with open(os.path.join(tmp, key), "wb") as f:
                f.write(value)
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": use_ocdbt, "use_zarr3": zarr3,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def relayout(src: str, dst: str, zarr3: bool, use_ocdbt: bool, bfloat16: bool = False) -> None:
    tree = restore_checkpoint(src)
    write_layout(dst, cast_bfloat16(tree) if bfloat16 else tree, zarr3, use_ocdbt)


def leaf_digests(tree, prefix: str = "") -> dict:
    """{dotted key path: {sha256, dtype, shape}} of every leaf but None:
    arrays by their bytes (bfloat16 by its bits, dtype "bfloat16"),
    scalars and strings by their repr (dtype "int", "float", "str")."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(leaf_digests(v, name))
            continue
        if v is None:
            continue
        if isinstance(v, (bool, int, float, str)):
            data, dtype, shape = repr(v).encode(), type(v).__name__, []
        elif isinstance(v, torch.Tensor):
            data, dtype, shape = v.contiguous().view(torch.int16).numpy().tobytes(), \
                "bfloat16", list(v.shape)
        else:
            a = np.asarray(v)
            dtype = "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str
            data, shape = np.ascontiguousarray(a).tobytes(), list(a.shape)
        out[name] = {"sha256": hashlib.sha256(data).hexdigest(), "dtype": dtype,
                     "shape": shape}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--zarr3", action="store_true")
    p.add_argument("--no-ocdbt", action="store_true")
    p.add_argument("--bfloat16", action="store_true")
    a = p.parse_args(argv)
    relayout(a.src, a.dst, a.zarr3, not a.no_ocdbt, a.bfloat16)


if __name__ == "__main__":
    main()
