"""Every orbax layout the JAX package reads, read by the port without JAX,
orbax or tensorstore (`utils/checkpoints.py`), held against orbax and
tensorstore, which are oracles here only; and the port's kernel inventory
(`ops/`) and perf bands (`utils/bands.py`) against the JAX package's.

- The committed fixtures `tests/torch_orbax/layouts/` (written by
  `make_fixture.py` with orbax's `PyTreeCheckpointHandler`: zarr v2 and
  zarr3, with and without OCDBT; a bfloat16 training state; every dtype,
  chunked leaves, scalars, strings, None) restore equal to orbax's untyped
  restore leaf for leaf and bit for bit (bfloat16 through its 16 bits),
  and to their digests; rewriting them with orbax gives the same digests.
- zarr3 shards of several inner chunks (index at the start or the end,
  with or without CRC-32C, absent inner chunks), edge chunks, missing
  chunks, zarr v2 with '/' keys and no compressor, as tensorstore writes
  them, read as tensorstore reads them.
- At full width (ResNet-18 + IEF) in every layout: the port's predict
  equals the JAX predict on the same directory (float32 encoders, 1e-4 as
  `tests/test_torch_orbax.py`; bfloat16 parameters widened to float32 in
  both); a one-epoch resume from each float32 layout equals the resume
  from the `.pt`, and from a bfloat16 state is refused by name.
- `tests/torch_orbax/relayout.py` rewrites a port-written directory into
  the other layouts, which orbax restores equal to the source.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import straps_tpu.ops as jax_ops
import straps_tpu_torch.ops as torch_ops
from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.predict import pipeline as JP
from straps_tpu.smpl import load_synthetic_assets as jax_assets
from straps_tpu.utils import bands as jax_bands
from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.models.convert import torch_state_dict_to_flax
from straps_tpu_torch.models.regressor import build_regressor, init_random_weights
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.smpl.assets import load_synthetic_assets as torch_assets
from straps_tpu_torch.train.loop import build_training, train
from straps_tpu_torch.utils import bands as torch_bands
from straps_tpu_torch.utils.checkpoints import (
    checkpoint_from_tree, checkpoint_path, load_checkpoint, orbax_checkpoint_path,
    restore_checkpoint, save_orbax_checkpoint, write_tree,
)
from torch_orbax import make_fixture, relayout
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))

LAYOUT_DIR = os.path.join(HERE, "torch_orbax", "layouts")
with open(os.path.join(HERE, "torch_orbax", "layouts.json")) as _f:
    DIGESTS = json.load(_f)
FIXTURES = sorted(DIGESTS)
IMG = 64
# (use_zarr3, use_ocdbt, bfloat16) of the full-width directories.
FULL = {"v2_ocdbt": (False, True, False), "v2_dir": (False, False, False),
        "zarr3_ocdbt": (True, True, False), "zarr3_dir": (True, False, False),
        "bf16_v2_ocdbt": (False, True, True), "bf16_zarr3_dir": (True, False, True)}


def _norm(x):
    """A leaf as (kind, shape, bytes): bfloat16 as its 16 bits, whether a
    torch tensor (the port) or an ml_dtypes / JAX array (orbax)."""
    if isinstance(x, (bool, int, float, str)):
        return type(x).__name__, (), repr(x)
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    a = np.asarray(x)
    kind = "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str
    return kind, a.shape, np.ascontiguousarray(a).tobytes()


def _assert_same_tree(got, want):
    (gl, gdef) = jax.tree_util.tree_flatten_with_path(got)
    (wl, wdef) = jax.tree_util.tree_flatten_with_path(want)
    assert gdef == wdef
    for (gp, g), (wp, w) in zip(gl, wl):
        assert gp == wp and _norm(g) == _norm(w), gp


def _checkpointer(zarr3, use_ocdbt):
    return ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=zarr3))


# ------------------------------------------------------- committed fixtures
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_restore_equals_orbax(name):
    path = os.path.join(LAYOUT_DIR, name)
    got = restore_checkpoint(path)
    _assert_same_tree(got, ocp.PyTreeCheckpointer().restore(path))
    assert relayout.leaf_digests(got) == DIGESTS[name]
    kinds = {d["dtype"] for d in DIGESTS[name].values()}
    if name.startswith("dtypes_"):
        assert kinds >= {"|b1", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2", "<u4", "<u8", "<f2",
                         "<f4", "<f8", "bfloat16", "int", "float", "str"}, kinds
        assert isinstance(got["bf16_np"], torch.Tensor) and got["string"] == "héllo wörld"
        assert got["nested"][1] is None and got["meta"]["note"] == "a/b ~ c"
    if name.startswith("bf16_"):
        assert got["state"]["params"]["encoder"]["conv1"]["kernel"].dtype == torch.bfloat16
        assert got["state"]["log_vars"]["verts"].dtype == np.float32


def test_fixtures_regenerate_to_their_digests(tmp_path):
    """orbax writes the same trees again (the bytes differ: OCDBT names
    its files by UUID)."""
    assert make_fixture.write_layouts(str(tmp_path / "layouts")) == DIGESTS
    sizes = [sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in
                 os.walk(os.path.join(LAYOUT_DIR, f)) for n in ns) for f in FIXTURES]
    assert max(sizes) < 100_000, sizes


# ------------------------------------------------ chunk forms (tensorstore)
def _ts_spec(root, form):
    little = {"name": "bytes", "configuration": {"endian": "little"}}
    zstd5 = {"name": "zstd", "configuration": {"level": 5, "checksum": False}}
    if form == "shards_index_start":
        codecs = [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": [2, 3], "codecs": [little, zstd5],
            "index_codecs": [little, {"name": "crc32c"}], "index_location": "start"}}]
        meta = {"shape": [7, 8], "data_type": "float32", "fill_value": 1.5, "codecs": codecs,
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [4, 6]}}}
    elif form == "shards_bf16_no_crc_dot_keys":
        codecs = [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": [3], "codecs": [little, zstd5], "index_codecs": [little]}}]
        meta = {"shape": [20], "data_type": "bfloat16", "fill_value": "NaN", "codecs": codecs,
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [9]}},
                "chunk_key_encoding": {"name": "default", "configuration": {"separator": "."}}}
    elif form == "unsharded_v2_keys":
        meta = {"shape": [5, 3], "data_type": "int64", "fill_value": -2,
                "codecs": [little, zstd5], "chunk_key_encoding": {"name": "v2"},
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [2, 2]}}}
    else:                                     # zarr v2, '/' keys, no compressor
        return {"driver": "zarr", "kvstore": {"driver": "file", "path": f"{root}/a/"},
                "metadata": {"shape": [5, 3], "chunks": [2, 2], "dtype": "<u2",
                             "compressor": None, "fill_value": 3,
                             "dimension_separator": "/"}, "create": True}
    return {"driver": "zarr3", "kvstore": {"driver": "file", "path": f"{root}/a/"},
            "metadata": meta, "create": True}


@pytest.mark.parametrize("form", ["shards_index_start", "shards_bf16_no_crc_dot_keys",
                                  "unsharded_v2_keys", "v2_slash_uncompressed"])
def test_chunk_forms_read_as_tensorstore_reads_them(form, tmp_path):
    root = str(tmp_path / form)
    t = ts.open(_ts_spec(root, form)).result()
    rng = np.random.RandomState(3)
    dtype = t.dtype.numpy_dtype
    region = tuple(slice(1, d - 1) for d in t.shape)          # leaves chunks unwritten
    values = rng.randn(*[d - 2 for d in t.shape]) * 100
    t[region].write(values.astype(dtype)).result()
    zarr3 = form != "v2_slash_uncompressed"
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": {"('a',)": {
            "key_metadata": [{"key": "a", "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
            "use_ocdbt": False, "use_zarr3": zarr3,
            "store_array_data_equal_to_fill_value": False}, f)
    got = restore_checkpoint(root)["a"]
    want = t.read().result()
    assert _norm(got) == _norm(want)
    _assert_same_tree({"a": got}, ocp.PyTreeCheckpointer().restore(root))
    # A checkpoint that says every chunk was written and lacks one fails.
    chunks = sorted(os.path.join(d, n) for d, _, ns in os.walk(os.path.join(root, "a"))
                    for n in ns if n not in ("zarr.json", ".zarray"))
    os.remove(chunks[0])
    meta = json.load(open(os.path.join(root, "_METADATA")))
    json.dump({**meta, "store_array_data_equal_to_fill_value": True},
              open(os.path.join(root, "_METADATA"), "w"))
    with pytest.raises(ValueError, match="is missing"):
        restore_checkpoint(root)


# ------------------------------------------------------- test-side writer
@pytest.mark.parametrize("layout", ["v2_dir", "zarr3_ocdbt", "zarr3_dir", "bf16_zarr3_ocdbt"])
def test_relayout_is_restored_by_orbax(layout, tmp_path):
    src = str(tmp_path / "port_written")
    write_tree(src, restore_checkpoint(os.path.join(LAYOUT_DIR, "state_v2_ocdbt")))
    dst = str(tmp_path / layout)
    relayout.relayout(src, dst, zarr3="zarr3" in layout, use_ocdbt="ocdbt" in layout,
                      bfloat16=layout.startswith("bf16"))
    want = ocp.PyTreeCheckpointer().restore(src)
    if layout.startswith("bf16"):               # rounded as JAX rounds: ml_dtypes' astype
        want = jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(x).astype(
            jnp.bfloat16) if (".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                              + ".").startswith(relayout.BFLOAT16_LEAVES) else x, want)
    _assert_same_tree(ocp.PyTreeCheckpointer().restore(dst), want)
    _assert_same_tree(restore_checkpoint(dst), want)
    with open(os.path.join(dst, "_METADATA")) as f:
        meta = json.load(f)
    assert (meta["use_zarr3"], meta["use_ocdbt"]) == ("zarr3" in layout, "ocdbt" in layout)


# ------------------------------------------------------------ full width
@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """Seeded ResNet-18 + IEF variables (BatchNorm statistics drawn too) as
    `{params, batch_stats}` in every layout of `FULL`, written by orbax."""
    tmp = tmp_path_factory.mktemp("layouts_full")
    tassets = torch_assets(device="cpu")
    model = build_regressor(tassets.mean_pose_6d, tassets.mean_shape)
    init_random_weights(model, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = (0.1 * rng.randn(*sd[k].shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = (1 + 0.2 * rng.rand(*sd[k].shape)).astype(np.float32)
    variables = torch_state_dict_to_flax(sd)
    low = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(jnp.bfloat16), variables)
    dirs = {}
    for name, (zarr3, use_ocdbt, bf16) in FULL.items():
        dirs[name] = str(tmp / name)
        _checkpointer(zarr3, use_ocdbt).save(dirs[name], args=ocp.args.PyTreeSave(
            low if bf16 else variables))
    yield {"dirs": dirs, "tassets": tassets, "jassets": jax_assets()}
    shutil.rmtree(tmp)                                       # ~47 MB a directory


@pytest.fixture(scope="module")
def jax_outputs(full_width):
    """The JAX predict's outputs per parameter dtype (one compile each);
    each layout's JAX variables are held bit-equal to these."""
    rng = np.random.RandomState(5)
    proxies = rng.rand(3, IMG, IMG, 18).astype(np.float32)
    proxies[..., 0] = proxies[..., 0] > 0.5
    out = {}
    for name in ("v2_ocdbt", "bf16_v2_ocdbt"):
        cfg = JaxPredictConfig(checkpoint=full_width["dirs"][name], img_wh=IMG)
        cfg.model.compute_dtype = None
        model, variables, mode = JP.load_regressor_variables(cfg, full_width["jassets"])
        got = JP.make_predict_fn(model, variables, full_width["jassets"], IMG)(proxies)
        out[name.startswith("bf16")] = (variables, {k: np.asarray(v) for k, v in got.items()})
    return proxies, out


@pytest.mark.parametrize("layout", list(FULL))
def test_predict_on_each_layout_matches_jax(layout, full_width, jax_outputs):
    path = full_width["dirs"][layout]
    proxies, by_dtype = jax_outputs
    want_vars, want = by_dtype[layout.startswith("bf16")]
    jcfg = JaxPredictConfig(checkpoint=path, img_wh=IMG)
    _, jvars, _ = JP.load_regressor_variables(jcfg, full_width["jassets"])
    _assert_same_tree(jvars, want_vars)            # the JAX predict's inputs, bit for bit
    cfg = PredictConfig(checkpoint=path, img_wh=IMG)
    cfg.model.compute_dtype = None
    model, mode = TP.load_regressor_variables(cfg, full_width["tassets"], device="cpu")
    assert mode == "clean"
    got = TP.make_predict_fn(model, full_width["tassets"], IMG)(torch.as_tensor(proxies))
    for key in ("cam_wp", "shape", "pose_rotmats", "verts", "reposed_verts", "joints3d_all"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)
    if layout.startswith("bf16"):                  # widened exactly: bfloat16 values in f32
        w = model.state_dict()["image_encoder.conv1.weight"]
        assert torch.equal(w, w.to(torch.bfloat16).float())


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_bfloat16_variance_batchnorm_matches_flax(scale_dtype):
    """One evaluation-mode BatchNorm on a bfloat16 running variance (and
    mean, bias; the scale either dtype) against flax's under jit: to float32
    rounding with `bfloat16_variance`, far from it with the widened
    variance alone."""
    import flax.linen as nn
    from straps_tpu_torch.models.resnet import BatchNorm2d
    rng = np.random.RandomState(2)
    c = 64
    x = rng.randn(2, 5, 5, c).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(c)).astype(jnp.bfloat16),
             "var": (rng.rand(c) * rng.choice([1e-3, 1.0, 30.0], c)).astype(jnp.bfloat16)}
    params = {"scale": (1 + 0.1 * rng.randn(c)).astype(jnp.dtype(scale_dtype)),
              "bias": (0.05 * rng.randn(c)).astype(jnp.bfloat16)}
    bn = nn.BatchNorm(use_running_average=True, epsilon=1e-5, momentum=0.9)
    want = np.asarray(jax.jit(bn.apply)({"params": params, "batch_stats": stats}, x))
    m = BatchNorm2d(c, eps=1e-5).eval()
    with torch.no_grad():
        for name, v in (("running_mean", stats["mean"]), ("running_var", stats["var"]),
                        ("weight", params["scale"]), ("bias", params["bias"])):
            getattr(m, name).copy_(torch.from_numpy(np.asarray(v, np.float32)))
        widened = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        m.bfloat16_variance = "root" if scale_dtype == "bfloat16" else "sum"
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    assert np.abs(widened - want).max() > 1e-4 * scale


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One port epoch at 64², B=4 (its `.pt` and log), and its state as a
    JAX orbax directory in each float32 layout (`save_orbax_checkpoint`,
    then orbax's own save of orbax's restore of it)."""
    tmp = tmp_path_factory.mktemp("layouts_resume")
    cfg = TrainConfig(img_wh=IMG, batch_size=4, focal_length=1250.0, num_epochs=1)
    cfg.model.compute_dtype = None
    cfg.train_path = write_synthetic_corpus(str(tmp / "train.npz"), n=8)
    cfg.val_path = write_synthetic_corpus(str(tmp / "val.npz"), n=8, seed=1)
    cfg.model_save_path = str(tmp / "first" / "model")
    cfg.log_path = str(tmp / "first" / "log.pkl")
    train(cfg, max_steps_per_epoch=1, verbose=False, device="cpu")
    pt = checkpoint_path(cfg.model_save_path, 0)
    saved = load_checkpoint(pt)
    state = build_training(cfg, device="cpu")[2]
    state.load_state_dict(saved["state"])
    dirs = {"v2_ocdbt": str(tmp / "v2_ocdbt")}
    save_orbax_checkpoint(dirs["v2_ocdbt"], state, epoch=saved["epoch"],
                          best_epoch=saved["best_epoch"], best_params=saved["best_params"],
                          best_epoch_val_metrics=saved["best_epoch_val_metrics"],
                          heatmap_mode=saved["meta"]["heatmap_mode"])
    tree = ocp.PyTreeCheckpointer().restore(dirs["v2_ocdbt"])
    for name in ("v2_dir", "zarr3_ocdbt", "zarr3_dir"):
        dirs[name] = str(tmp / name)
        _checkpointer(*FULL[name][:2]).save(dirs[name], args=ocp.args.PyTreeSave(tree))
    yield {"cfg": cfg, "pt": pt, "dirs": dirs, "tmp": tmp,
           "from_pt": _resume(tmp, "pt", cfg, lambda p: shutil.copy(pt, checkpoint_path(p, 0)))}
    shutil.rmtree(tmp)                                       # ~190 MB a directory


def _resume(tmp, name, cfg0, place):
    """One more epoch (one train step) from epoch 0 placed by `place`."""
    cfg = TrainConfig(**{k: getattr(cfg0, k) for k in ("img_wh", "batch_size", "focal_length",
                                                        "train_path", "val_path")})
    cfg.model.compute_dtype = None
    cfg.num_epochs, cfg.epochs_per_save, cfg.resume_from_epoch = 2, 1, 0
    cfg.model_save_path = str(tmp / f"resume_{name}" / "ckpt" / "model")
    cfg.log_path = str(tmp / f"resume_{name}" / "log.pkl")
    os.makedirs(os.path.dirname(cfg.model_save_path))
    shutil.copy(cfg0.log_path, cfg.log_path)
    place(cfg.model_save_path)
    state, best, tracker = train(cfg, max_steps_per_epoch=1, verbose=False, device="cpu")
    shutil.rmtree(os.path.dirname(cfg.model_save_path))
    return state, best, tracker


@pytest.mark.parametrize("layout", ["v2_ocdbt", "v2_dir", "zarr3_ocdbt", "zarr3_dir"])
def test_resume_from_each_layout_equals_the_pt(layout, trained):
    s_pt, best_pt, tr_pt = trained["from_pt"]
    s, best, tr = _resume(trained["tmp"], layout, trained["cfg"], lambda p: shutil.copytree(
        trained["dirs"][layout], orbax_checkpoint_path(p, 0)))
    assert tr.history == tr_pt.history and len(tr.history["train_losses"]) == 2
    # Every tensor bit for bit, BatchNorm's `num_batches_tracked` aside: the
    # JAX tree holds no such counter (a directory reads as 0, the `.pt`
    # counts the steps), and BatchNorm never reads it (its momentum is fixed).
    assert s.step == s_pt.step == 2
    a, b = s.model.state_dict(), s_pt.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b if not k.endswith("num_batches_tracked"))
    assert all(torch.equal(s.log_vars[k], s_pt.log_vars[k]) for k in s_pt.log_vars)
    assert all(torch.equal(best[k], best_pt[k]) for k in best_pt)
    a, b = s.optimizer.state_dict()["state"], s_pt.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i][k], b[i][k]) for i in b for k in b[i])


def test_checkpoint_from_a_bfloat16_tree_widens_exactly(trained):
    """`checkpoint_from_tree` (what `load_checkpoint` of a directory gives
    outside a resume) on the full-width tree with its parameters,
    statistics and moments cast to bfloat16: every tensor is the `.pt`'s
    rounded to bfloat16, in float32."""
    tree = relayout.cast_bfloat16(restore_checkpoint(trained["dirs"]["v2_ocdbt"]))
    got, want = checkpoint_from_tree(tree), load_checkpoint(trained["pt"])

    def rounded(t):
        return t.to(torch.bfloat16).float() if t.is_floating_point() else t
    for k, v in want["state"]["model"].items():
        if not k.endswith("num_batches_tracked"):
            assert got["state"]["model"][k].dtype == torch.float32
            assert torch.equal(got["state"]["model"][k], rounded(v)), k
    assert all(torch.equal(got["best_params"][k], rounded(v))
               for k, v in want["best_params"].items())
    for i, st in want["state"]["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"]["optimizer"]["state"][i][k], rounded(st[k]))


@pytest.mark.parametrize("name", ["bf16_state_v2_ocdbt", "bf16_state_zarr3_dir"])
def test_bfloat16_resume_is_refused_by_name(name, tmp_path):
    path = os.path.join(LAYOUT_DIR, name)
    with pytest.raises(ValueError, match="bfloat16 training state is not supported"):
        load_checkpoint(path, resume=True)
    cfg = TrainConfig(img_wh=IMG, batch_size=4, focal_length=1250.0, num_epochs=2,
                      resume_from_epoch=3)
    cfg.train_path = write_synthetic_corpus(str(tmp_path / "train.npz"), n=4)
    cfg.val_path = cfg.train_path
    cfg.model_save_path = str(tmp_path / "ckpt" / "model")
    cfg.log_path = str(tmp_path / "log.pkl")
    shutil.copytree(path, orbax_checkpoint_path(cfg.model_save_path, 3))
    with pytest.raises(ValueError, match="bfloat16 training state is not supported"):
        train(cfg, max_steps_per_epoch=1, verbose=False, device="cpu")


# ---------------------------------------------------------- ops and bands
@pytest.mark.parametrize("name", jax_ops.__all__)
def test_ops_inventory_maps_every_jax_name(name):
    port = torch_ops.JAX_COUNTERPARTS[name]
    assert port and all(p in torch_ops.__all__ and getattr(torch_ops, p) is not None
                        for p in port)
    if name == "FACE_CHUNK":
        assert torch_ops.FACE_CHUNK == jax_ops.FACE_CHUNK
    else:
        assert all(callable(getattr(torch_ops, p)) for p in port)


def test_ops_inventory_lists_only_its_names():
    """Every port name is some JAX name's counterpart; importing the
    inventory, in a fresh process, loads no kernel or host library."""
    assert sorted(torch_ops.JAX_COUNTERPARTS) == sorted(jax_ops.__all__)
    assert sorted({p for ps in torch_ops.JAX_COUNTERPARTS.values() for p in ps}) == \
        sorted(torch_ops.__all__)
    code = ("import straps_tpu_torch.ops, sys\n"
            "from straps_tpu_torch.utils import native_build\n"
            "assert native_build.KERNEL_LIBRARIES and native_build._LIBRARIES == {}\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=os.path.dirname(HERE))


BANDS = {"tput": {"value": 100.0, "rel_tol": 0.2, "direction": "min", "unit": "img/s"},
         "lat": {"value": 100.0, "rel_tol": 0.1, "direction": "max", "unit": "ms"},
         "lat_default": {"value": 3.5}}


@pytest.mark.parametrize("name,value", [("tput", 100.0), ("tput", 81.0), ("tput", 79.0),
                                        ("tput", 500.0), ("lat", 109.0), ("lat", 111.0),
                                        ("lat", 1.0), ("lat_default", 4.2),
                                        ("lat_default", 4.21), ("absent", 1e9)])
def test_check_band_matches_jax(name, value):
    lines = []
    for module in (jax_bands, torch_bands):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            ok = module.check_band(name, value, BANDS)
        lines.append((ok, out.getvalue()))
    assert lines[0] == lines[1]


@pytest.mark.parametrize("which", ["explicit", "absent"])
def test_load_bands_matches_jax(which, tmp_path):
    path = tmp_path / "bands.json"
    if which == "explicit":
        path.write_text(json.dumps(BANDS))
    got = torch_bands.load_bands(str(path))
    assert got == jax_bands.load_bands(str(path)) == (BANDS if which == "explicit" else {})
    assert os.path.basename(torch_bands.BANDS_PATH) == "BENCH_BANDS_TORCH.json"
    assert os.path.dirname(torch_bands.BANDS_PATH) == os.path.dirname(HERE)
