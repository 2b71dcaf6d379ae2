#!/usr/bin/env python3
"""Write the committed orbax fixtures of the port's checkpoint reader:

    python tests/torch_orbax/make_fixture.py

Runs where JAX, optax and orbax are installed.  It saves, with the JAX
package's own `save_checkpoint`, a seeded `TrainState` tree of narrowed
leaf sizes (a ResNet-18-named encoder of stage widths 2-16 with a wide
stem, the IEF head, BatchNorm statistics, log-variances, optax Adam's
state, the step) into `jax_ckpt_epoch3/`, then writes `digests.json`: the
SHA-256, dtype and shape of every leaf as orbax's own untyped restore
returns it.  The leaves are chosen so that the zstd frames orbax writes
hold every block, literals and sequence-table mode the port's decoder
reads: float32 weights of a trained model's spread (Huffman literals in 4
streams, across the blocks of the 141 KB stem), weights on a 2^-8 grid
(long matches: FSE-coded sequence tables, repeated offsets), small arrays
(1-stream Huffman, raw literals), a zero tail past a frame's first block
(an RLE block), int32 and uint8 leaves.

It then writes `layouts/`, one directory for each layout that orbax's
`PyTreeCheckpointHandler` writes (`LAYOUTS`: zarr v2 or zarr3, with or
without OCDBT), each through `save_checkpoint` with its checkpointer built
with those options: `state_<layout>` holds a narrower `TrainState` tree
(`NARROW`: a stem of width 1, one stage of one block, IEF hidden width
2, so that `_METADATA` stays small),
`bf16_state_<layout>` (v2 with OCDBT, zarr3 without) the same with the
parameters, BatchNorm statistics and Adam moments cast to bfloat16, and
`dtypes_<layout>` a small tree of every dtype orbax writes for a numpy or
JAX array (bool, int8-64, uint8-64, float16/32/64, bfloat16 as numpy and
as a `jax.Array`), leaves split into several chunks, a 0-d array, int
and float scalars, strings and None.  `layouts.json` holds each one's
`relayout.py::leaf_digests` as orbax's untyped restore returns it.
"""

import json
import os
import shutil
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402
import orbax.checkpoint as ocp                                # noqa: E402

from straps_tpu.train.state import TrainState, make_optimizer  # noqa: E402
from straps_tpu.utils import checkpoints as jax_checkpoints   # noqa: E402
from straps_tpu.utils.checkpoints import save_checkpoint      # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
from relayout import leaf_digests                            # noqa: E402

CKPT = os.path.join(HERE, "jax_ckpt_epoch3")
DIGESTS = os.path.join(HERE, "digests.json")
LAYOUTS_DIR = os.path.join(HERE, "layouts")
LAYOUTS_JSON = os.path.join(HERE, "layouts.json")
STEM, WIDTHS, HIDDEN = 40, (2, 4, 8, 16), 32
TASKS = ("verts", "shape_params", "pose_params", "joints2D", "joints3D")
# (use_zarr3, use_ocdbt) of each layout.
LAYOUTS = {"v2_ocdbt": (False, True), "v2_dir": (False, False), "zarr3_ocdbt": (True, True),
           "zarr3_dir": (True, False)}
BF16_LAYOUTS = ("v2_ocdbt", "zarr3_dir")
NARROW = {"stem": 1, "widths": (1,), "hidden": 2, "blocks": 1}


def _tree(rng, fill, stem=STEM, widths=WIDTHS, hidden=HIDDEN, blocks=2):
    """A ResNet-18-named encoder and the IEF head, each leaf `fill(shape,
    fan_in, name)`."""
    enc = {"conv1": {"kernel": fill((7, 7, 18, stem), 7 * 7 * 18, "stem")},
           "bn1": {"scale": fill((stem,), 0, "scale"), "bias": fill((stem,), 0, "bias")}}
    cin = stem
    for s, w in enumerate(widths, start=1):
        for b in range(blocks):
            blk = {"conv1": {"kernel": fill((3, 3, cin, w), 9 * cin, "conv")},
                   "conv2": {"kernel": fill((3, 3, w, w), 9 * w, "conv")}}
            for bn in ("bn1", "bn2"):
                blk[bn] = {"scale": fill((w,), 0, "scale"), "bias": fill((w,), 0, "bias")}
            if b == 0 and (s > 1 or cin != w):
                blk["downsample_conv"] = {"kernel": fill((1, 1, cin, w), cin, "conv")}
                blk["downsample_bn"] = {"scale": fill((w,), 0, "scale"),
                                        "bias": fill((w,), 0, "bias")}
            enc[f"layer{s}_{b}"] = blk
            cin = w
    feat, h = widths[-1], hidden
    ief = {"fc1": {"kernel": fill((feat + 157, h), feat + 157, "fc"),
                   "bias": fill((h,), 0, "bias")},
           "fc2": {"kernel": fill((h, h), h, "fc"), "bias": fill((h,), 0, "bias")},
           "fc3": {"kernel": fill((h, 157), h, "fc"), "bias": fill((157,), 0, "bias")}}
    return {"encoder": enc, "ief": ief}


def make_tree(seed: int = 0, stem=STEM, widths=WIDTHS, hidden=HIDDEN, blocks=2):
    rng = np.random.RandomState(seed)

    def weight(shape, fan_in, kind):
        if kind == "stem":            # on a 2^-8 grid: long matches, FSE tables
            return np.round(rng.randn(*shape) * np.sqrt(2.0 / fan_in) * 256) / 256
        if kind == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if kind == "bias":
            return 0.05 * rng.randn(*shape)
        return rng.randn(*shape) * np.sqrt(2.0 / fan_in)

    def f32(fn):
        return lambda shape, fan_in, kind: np.asarray(fn(shape, fan_in, kind), np.float32)

    params = _tree(rng, f32(weight), stem, widths, hidden, blocks)
    best = _tree(rng, f32(weight), stem, widths, hidden, blocks)
    bs = {"encoder": {k: {m: {"mean": np.zeros(v["scale"].shape, np.float32),
                              "var": np.float32(1.0) + np.abs(0.2 * rng.randn(*v["scale"].shape)
                                                              ).astype(np.float32)}
                          for m, v in blk.items() if "scale" in v}
                      for k, blk in params["encoder"].items() if k.startswith("layer")}}
    bs["encoder"]["bn1"] = {"mean": 0.01 * rng.randn(stem).astype(np.float32),
                            "var": np.ones(stem, np.float32)}
    lv = {t: jnp.asarray(rng.randn() * 0.5, jnp.float32) for t in TASKS}
    tx = make_optimizer(1e-4)
    opt = tx.init((params, lv))
    adam = opt[0]
    mu = jax.tree_util.tree_map(lambda x: np.asarray(1e-4 * rng.randn(*x.shape), np.float32),
                                adam.mu)
    nu = jax.tree_util.tree_map(lambda x: np.asarray(1e-8 * rng.randn(*x.shape) ** 2, np.float32),
                                adam.nu)
    # The stem's last kernel row never updated: a zero tail past the frame's
    # first 128 KB block (an RLE block).
    nu[0]["encoder"]["conv1"]["kernel"][6] = 0.0
    opt = (adam._replace(count=jnp.asarray(1234, jnp.int32), mu=mu, nu=nu),) + tuple(opt[1:])
    state = TrainState(params=params, batch_stats=bs, log_vars=lv, opt_state=opt,
                       step=jnp.asarray(1234, jnp.int32))
    return state, best


def _checkpointer(zarr3: bool, use_ocdbt: bool):
    return ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=zarr3))


def save_state(path, state, best, zarr3: bool, use_ocdbt: bool):
    """The JAX package's `save_checkpoint` of `state`, its checkpointer
    built with the layout's options."""
    saved = jax_checkpoints.ocp
    jax_checkpoints.ocp = types.SimpleNamespace(
        PyTreeCheckpointer=lambda: _checkpointer(zarr3, use_ocdbt))
    try:
        save_checkpoint(path, state, epoch=3, best_epoch=2, best_params=best,
                        best_epoch_val_metrics={"pves_pa": 0.0625, "mpjpes_pa": 0.03125},
                        heatmap_mode="clean")
    finally:
        jax_checkpoints.ocp = saved


def to_bfloat16(state, best):
    """The parameters, BatchNorm statistics and Adam moments as bfloat16."""
    def cast(t):
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    adam = state.opt_state[0]
    opt = (adam._replace(mu=cast(adam.mu), nu=cast(adam.nu)),) + tuple(state.opt_state[1:])
    return state.replace(params=cast(state.params), batch_stats=cast(state.batch_stats),
                         opt_state=opt), cast(best)


def dtype_tree(seed: int = 7):
    """Every dtype orbax writes for an array, chunked leaves, scalars,
    strings and None; and its `SaveArgs` (the chunked leaves' chunk byte
    sizes)."""
    rng = np.random.RandomState(seed)
    tree = {"bool": rng.rand(9) > 0.5, "nested": [np.arange(3, dtype=np.uint8), None,
                                                    {"zero_d": np.asarray(-7, np.int32)}],
            "float": 2.5, "int": -3, "np_float64": np.float64(-0.125),
            "string": "héllo wörld", "meta": {"note": "a/b ~ c"},
            "specials": np.array([np.nan, np.inf, -np.inf, -0.0, 1e-40], np.float32),
            "bf16_np": np.asarray(rng.randn(2, 3).astype(np.float32), jnp.bfloat16),
            "bf16_jax": jnp.asarray(rng.randn(5), jnp.bfloat16),
            "chunked_f32": rng.randn(6, 8).astype(np.float32),
            "chunked_i16": np.arange(-12, 12, dtype=np.int16).reshape(4, 6)}
    for bits in (8, 16, 32, 64):
        lo = -(1 << (bits - 1))
        tree[f"int{bits}"] = rng.randint(lo, -lo, size=(3, 2), dtype=np.dtype(f"i{bits // 8}"))
        tree[f"uint{bits}"] = rng.randint(0, 1 << min(bits, 63), size=(2, 3),
                                          dtype=np.dtype(f"u{bits // 8}"))
    for bits in (16, 32, 64):
        tree[f"float{bits}"] = rng.randn(4).astype(f"f{bits // 8}")
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), tree)
    save_args["chunked_f32"] = ocp.SaveArgs(chunk_byte_size=48)
    save_args["chunked_i16"] = ocp.SaveArgs(chunk_byte_size=8)
    return tree, save_args


def write_layouts(out_dir: str) -> dict:
    """Every layout fixture under `out_dir`; returns their digests, each
    from orbax's untyped restore."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    state, best = make_tree(**NARROW)
    tree, save_args = dtype_tree()
    digests = {}
    for layout, (zarr3, use_ocdbt) in LAYOUTS.items():
        save_state(os.path.join(out_dir, f"state_{layout}"), state, best, zarr3, use_ocdbt)
        if layout in BF16_LAYOUTS:
            save_state(os.path.join(out_dir, f"bf16_state_{layout}"), *to_bfloat16(state, best),
                       zarr3, use_ocdbt)
        _checkpointer(zarr3, use_ocdbt).save(os.path.join(out_dir, f"dtypes_{layout}"),
                                            args=ocp.args.PyTreeSave(tree, save_args=save_args))
    for name in sorted(os.listdir(out_dir)):
        digests[name] = leaf_digests(ocp.PyTreeCheckpointer().restore(
            os.path.join(out_dir, name)))
    return digests


def main():
    shutil.rmtree(CKPT, ignore_errors=True)
    state, best = make_tree()
    save_checkpoint(CKPT, state, epoch=3, best_epoch=2, best_params=best,
                    best_epoch_val_metrics={"pves_pa": 0.0625, "mpjpes_pa": 0.03125},
                    heatmap_mode="clean")
    restored = ocp.PyTreeCheckpointer().restore(CKPT)
    with open(DIGESTS, "w") as f:
        json.dump(leaf_digests(restored), f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(CKPT) for n in ns)
    print(f"{CKPT}: {size} bytes, {len(leaf_digests(restored))} leaves")
    digests = write_layouts(LAYOUTS_DIR)
    with open(LAYOUTS_JSON, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    for name in sorted(digests):
        d = os.path.join(LAYOUTS_DIR, name)
        size = sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(d) for n in ns)
        print(f"{d}: {size} bytes, {len(digests[name])} leaves")


if __name__ == "__main__":
    main()
