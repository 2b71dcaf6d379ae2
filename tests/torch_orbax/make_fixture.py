#!/usr/bin/env python3
"""Write the committed orbax fixture of the port's checkpoint reader:

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
"""

import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402
import orbax.checkpoint as ocp                                # noqa: E402

from straps_tpu.train.state import TrainState, make_optimizer  # noqa: E402
from straps_tpu.utils.checkpoints import save_checkpoint      # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "jax_ckpt_epoch3")
DIGESTS = os.path.join(HERE, "digests.json")
STEM, WIDTHS = 40, (2, 4, 8, 16)
TASKS = ("verts", "shape_params", "pose_params", "joints2D", "joints3D")


def _tree(rng, fill):
    """A ResNet-18-named encoder and the IEF head, each leaf `fill(shape,
    fan_in, name)`."""
    enc = {"conv1": {"kernel": fill((7, 7, 18, STEM), 7 * 7 * 18, "stem")},
           "bn1": {"scale": fill((STEM,), 0, "scale"), "bias": fill((STEM,), 0, "bias")}}
    cin = STEM
    for s, w in enumerate(WIDTHS, start=1):
        for b in range(2):
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
    feat = WIDTHS[-1]
    ief = {"fc1": {"kernel": fill((feat + 157, 32), feat + 157, "fc"),
                   "bias": fill((32,), 0, "bias")},
           "fc2": {"kernel": fill((32, 32), 32, "fc"), "bias": fill((32,), 0, "bias")},
           "fc3": {"kernel": fill((32, 157), 32, "fc"), "bias": fill((157,), 0, "bias")}}
    return {"encoder": enc, "ief": ief}


def make_tree(seed: int = 0):
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

    params = _tree(rng, f32(weight))
    best = _tree(rng, f32(weight))
    bs = {"encoder": {k: {m: {"mean": np.zeros(v["scale"].shape, np.float32),
                              "var": np.float32(1.0) + np.abs(0.2 * rng.randn(*v["scale"].shape)
                                                              ).astype(np.float32)}
                          for m, v in blk.items() if "scale" in v}
                      for k, blk in params["encoder"].items() if k.startswith("layer")}}
    bs["encoder"]["bn1"] = {"mean": 0.01 * rng.randn(STEM).astype(np.float32),
                            "var": np.ones(STEM, np.float32)}
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


def leaf_digests(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        a = np.ascontiguousarray(leaf) if np.ndim(leaf) else np.asarray(leaf)
        out[name] = {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                     "dtype": a.dtype.str, "shape": list(a.shape)}
    return out


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


if __name__ == "__main__":
    main()
