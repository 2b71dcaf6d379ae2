"""The JAX package's orbax checkpoints read and written by the port
without JAX, orbax or tensorstore (`utils/ocdbt.py`, `utils/zstd.py`,
`utils/checkpoints.py`), held against those packages, which are oracles
here only.

- The OCDBT reader's keys and values equal tensorstore's `list()`/`read()`
  on the JAX package's checkpoints, on databases with a version tree and
  with interior b-tree nodes, and on the port's own writes.
- `restore_checkpoint` equals orbax's untyped restore leaf for leaf,
  bitwise, with the same tree structure.
- The committed fixture `tests/torch_orbax/` (written by the JAX package's
  `save_checkpoint`, `make_fixture.py`) reproduces its SHA-256 digests,
  and its frames reach every block, literals and sequence-table mode that
  orbax's zstd level 1 writes.
- On the JAX checkpoint of `tests/test_torch_orbax_export.py` (ResNet-18,
  after one JAX step), `load_checkpoint(dir)` equals the export tool's
  `.pt` on every tensor, bitwise; predict on the directory matches the JAX
  rollout to 1e-4 and the predict CLI writes the `.pt`'s outputs bit for
  bit; evaluation on it matches the JAX harness's on it to
  `tests/test_torch_eval.py`'s bounds; the port gate's rows on it equal the
  JAX gate's (float32 encoders); a resume from the directory gives the
  history and state of a resume from the `.pt`, bitwise.
- `save_orbax_checkpoint` is read by the JAX package's
  `restore_checkpoint(path, template)`, every leaf equal, and tensorstore
  lists the same keys as a JAX save of the same tree.
- Other compressors (gzip, blosc) and zarr3 codecs, a missing
  `_METADATA`, a corrupt node and numbered manifests are refused by name;
  bfloat16 leaves and zarr3 checkpoints are read
  (`tests/test_torch_orbax_layouts.py` holds every layout).
"""

import functools
import hashlib
import json
import os
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from straps_tpu.config import PredictConfig as JaxPredictConfig
from straps_tpu.eval_harness import runner as jax_runner
from straps_tpu.predict.pipeline import make_predict_fn as jax_predict_fn
from straps_tpu.utils.checkpoints import restore_checkpoint as jax_restore
from straps_tpu.utils.checkpoints import save_checkpoint as jax_save
from straps_tpu_torch.cli import run_predict
from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.eval_harness import runner as torch_runner
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.predict.pipeline import save_proxies
from straps_tpu_torch.train.loop import build_training, params_to_host, train
from straps_tpu_torch.utils import ocdbt, zstd
from straps_tpu_torch.utils.checkpoints import (
    checkpoint_path, load_checkpoint, orbax_checkpoint_path, restore_checkpoint,
    save_orbax_checkpoint, write_tree,
)
from test_torch_eval import METRICS as EVAL_METRICS
from test_torch_eval import _dataset as eval_dataset
from test_torch_orbax_export import IMG, LR, _load_tool, exported  # noqa: F401  (fixture)
from test_torch_parity_gate import (  # noqa: F401  (fixtures)
    _both_gates, float32_encoders, stand_ins,
)
from torch_orbax.relayout import write_layout
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_orbax", "jax_ckpt_epoch3")
DIGESTS = os.path.join(HERE, "torch_orbax", "digests.json")
# The modes orbax's zstd level 1 frames reach in the fixture (it writes no
# checksums or skippable frames; RLE literals and RLE or repeated sequence
# tables come at other levels, in `tests/test_torch_zstd.py`'s corpus).
FIXTURE_MODES = ("frames", "raw_blocks", "rle_blocks", "compressed_blocks", "raw_literals",
                 "huffman_literals", "treeless_literals", "huffman_1_stream",
                 "huffman_4_streams", "seq_predefined", "seq_fse")


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)


def _assert_trees_equal(got, want):
    (gl, gdef), (wl, wdef) = _flat(got), _flat(want)
    assert gdef == wdef
    for (gp, g), (wp, w) in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert gp == wp and g.dtype == w.dtype and g.shape == w.shape, (gp, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), gp


def _kvstore(root):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()


def _assert_reader_matches_tensorstore(root):
    reader, kv = ocdbt.OcdbtReader(root), _kvstore(root)
    keys = sorted(kv.list().result())
    assert reader.list() == keys and keys
    for k in keys:
        assert reader.read(k) == kv.read(k).result().value, k
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{root}/").result()).result()
    assert reader.versions()[-1]["generation_number"] == dump["versions"][-1]["generation_number"]
    return reader


def _many_versions(root):
    kv = _kvstore(root)
    for i in range(40):
        kv.write(f"k{i:03d}", bytes([i]) * (i * 97)).result()


def _interior_nodes(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 500,
                                     "max_inline_value_bytes": 16}}).result()
    txn = ts.Transaction()
    for i in range(300):
        kv.with_transaction(txn).write(f"key/{i:05d}/.zarray", b"x" * (i % 40)).result()
    txn.commit_async().result()


@pytest.mark.parametrize("case", ["fixture", "fixture_process_0", "many_versions",
                                  "interior_nodes"])
def test_ocdbt_reader_matches_tensorstore(case, tmp_path):
    if case.startswith("fixture"):
        root = FIXTURE if case == "fixture" else os.path.join(FIXTURE, "ocdbt.process_0")
    else:
        root = str(tmp_path / case)
        {"many_versions": _many_versions, "interior_nodes": _interior_nodes}[case](root)
    reader = _assert_reader_matches_tensorstore(root)
    if case == "many_versions":
        versions = reader.versions()
        assert [v["generation_number"] for v in versions] == list(range(1, 42))
        assert versions[0]["root"] is None                  # generation 1: the empty tree
    if case == "interior_nodes":
        dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{root}/").result()).result()
        assert dump["versions"][-1]["root_height"] >= 2


def test_ocdbt_reader_on_the_jax_checkpoint(exported):
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    reader = _assert_reader_matches_tensorstore(ckpt)
    assert len(reader.list()) == 2 * len(json.load(open(os.path.join(ckpt, "_METADATA")))
                                          ["tree_metadata"]) - 2   # opt_state.1 is None


@pytest.mark.parametrize("which", ["fixture", "jax_step"])
def test_restore_equals_orbax_untyped_restore(which, exported):
    path = FIXTURE if which == "fixture" else os.path.join(
        os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    _assert_trees_equal(restore_checkpoint(path), ocp.PyTreeCheckpointer().restore(path))


def test_fixture_reproduces_its_digests():
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE) for n in ns)
    assert size <= 1 << 20
    with open(DIGESTS) as f:
        want = json.load(f)
    zstd.mode_counts(reset=True)
    tree = restore_checkpoint(FIXTURE)
    counts = zstd.mode_counts()
    got = {}
    for path, leaf in _flat(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        got[name] = {"sha256": hashlib.sha256(leaf.tobytes()).hexdigest(),
                     "dtype": leaf.dtype.str, "shape": list(leaf.shape)}
    assert got == want
    assert {want[k]["dtype"] for k in want} == {"<f4", "<f8", "<i4", "<i8", "|u1"}
    assert all(counts[m] > 0 for m in FIXTURE_MODES), counts


def test_load_checkpoint_equals_the_export_tool(exported):
    """Every tensor bitwise.  Non-tensor fields: the param group's `lr`
    is `TrainConfig.lr` in both (the JAX checkpoint holds no learning
    rate; the tool takes it from the run's overrides, 1e-4 here)."""
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    got, want = load_checkpoint(ckpt), load_checkpoint(exported["out"])

    def same(a, b, where):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
            assert torch.equal(a, b) and a.numpy().tobytes() == b.numpy().tobytes(), where
        elif isinstance(b, dict):
            assert list(a) == list(b) if where.endswith("log_vars") else set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        else:
            assert a == b, (where, a, b)

    assert TrainConfig().lr == LR
    same(got, want, "checkpoint")


def test_predict_on_the_directory_matches_jax(exported):
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    cfg = PredictConfig(checkpoint=ckpt, img_wh=IMG)
    cfg.model.compute_dtype = None
    model, mode = TP.load_regressor_variables(cfg, exported["tassets"], device="cpu")
    assert mode == "legacy"
    rng = np.random.RandomState(5)
    proxies = rng.rand(3, IMG, IMG, 18).astype(np.float32)
    proxies[..., 0] = proxies[..., 0] > 0.5
    got = TP.make_predict_fn(model, exported["tassets"], IMG)(torch.as_tensor(proxies))
    state = exported["state"]
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = jax_predict_fn(exported["model"], variables, exported["jassets"],
                          IMG)(np.asarray(proxies))
    for key in ("cam_wp", "shape", "pose_rotmats", "verts", "reposed_verts", "joints3d_all"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    pt_cfg = PredictConfig(checkpoint=exported["out"], img_wh=IMG)
    pt_cfg.model.compute_dtype = None
    pt_model, _ = TP.load_regressor_variables(pt_cfg, exported["tassets"], device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), pt_model.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


def test_eval_on_the_directory_matches_jax(exported, monkeypatch):
    """Both packages' `run_evaluation` on the JAX checkpoint directory
    (float32 encoders, 64x64, the JAX renders through the packed Pallas
    kernel in interpret mode), held to `tests/test_torch_eval.py`'s
    bounds: vertex and joint metrics rtol 1e-3, silhouette IoU abs 2e-3."""
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    monkeypatch.setattr(jax_runner, "default_raster_backend", lambda wh: "pallas")
    monkeypatch.setattr(jax_runner, "render_silhouette",
                        functools.partial(jax_runner.render_silhouette, interpret=True))
    jcfg = JaxPredictConfig(img_wh=IMG, checkpoint=ckpt)
    jcfg.model.compute_dtype = None
    want = jax_runner.run_evaluation(eval_dataset(4), jcfg, metrics=EVAL_METRICS, batch_size=4)
    cfg = PredictConfig(img_wh=IMG, checkpoint=ckpt)
    cfg.model.compute_dtype = None
    got = torch_runner.run_evaluation(eval_dataset(4), cfg, metrics=EVAL_METRICS, batch_size=4,
                                      device="cpu")
    for k in EVAL_METRICS[:-1]:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert abs(got["silhouette_ious"] - want["silhouette_ious"]) <= 2e-3


def test_predict_cli_on_the_directory_equals_the_pt(exported, tmp_path):
    """`run_predict --checkpoint DIR` and `--checkpoint X.pt` (the export
    tool's) write bit-identical npy outputs."""
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    rng = np.random.RandomState(3)
    sils = (rng.rand(3, 128, 128) > 0.5).astype(np.float32)
    joints = rng.rand(3, 17, 2).astype(np.float32) * 128
    save_proxies(str(tmp_path / "proxies"), ["a", "b", "c"], sils, joints)
    outs = {}
    for kind, path in (("dir", ckpt), ("pt", exported["out"])):
        outs[kind] = tmp_path / kind
        run_predict.main(["--input", str(tmp_path / "proxies"), "--checkpoint", path,
                          "--out-dir", str(outs[kind]), "--device", "cpu", f"img_wh={IMG}",
                          "model.compute_dtype=None", "--no-vis"])
    names = sorted(f.name for f in outs["pt"].glob("*.npy"))
    assert len(names) == 12
    for name in names:
        assert np.load(outs["dir"] / name).tobytes() == np.load(outs["pt"] / name).tobytes()


def test_gate_rows_on_the_directory_equal_the_jax_gate(exported, stand_ins, float32_encoders,
                                                       capsys):
    root, common = stand_ins
    ckpt = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    args = list(common)
    args[args.index("--checkpoint") + 1] = ckpt
    _both_gates(args, root, "orbax", capsys)


def _resume(tmp, name, cfg0, place):
    cfg = TrainConfig(**{k: getattr(cfg0, k) for k in ("img_wh", "batch_size", "focal_length",
                                                        "lr", "train_path", "val_path")})
    cfg.model.compute_dtype = None
    cfg.num_epochs, cfg.epochs_per_save, cfg.resume_from_epoch = 2, 1, 0
    cfg.model_save_path = str(tmp / name / "ckpt" / "model")
    cfg.log_path = str(tmp / name / "log.pkl")
    os.makedirs(os.path.dirname(cfg.model_save_path))
    shutil.copy(cfg0.log_path, cfg.log_path)
    place(cfg.model_save_path)
    out = train(cfg, max_steps_per_epoch=1, verbose=False, device="cpu")
    shutil.rmtree(os.path.dirname(cfg.model_save_path))     # ~190 MB a checkpoint
    return out


def test_resume_from_the_directory_equals_resume_from_the_pt(exported, tmp_path):
    jax_dir = os.path.join(os.path.dirname(exported["out"]), "straps_model_checkpoint_epoch0")
    cfg0 = TrainConfig(img_wh=IMG, batch_size=4, focal_length=1250.0, lr=LR, num_epochs=1)
    cfg0.model.compute_dtype = None
    cfg0.train_path = write_synthetic_corpus(str(tmp_path / "train.npz"), n=8)
    cfg0.val_path = write_synthetic_corpus(str(tmp_path / "val.npz"), n=8, seed=1)
    cfg0.model_save_path = str(tmp_path / "first" / "model")
    cfg0.log_path = str(tmp_path / "first" / "log.pkl")
    train(cfg0, max_steps_per_epoch=1, verbose=False, device="cpu")     # the epoch-0 log
    os.remove(checkpoint_path(cfg0.model_save_path, 0))
    from_pt = _resume(tmp_path, "pt", cfg0, lambda p: shutil.copy(
        exported["out"], checkpoint_path(p, 0)))
    from_dir = _resume(tmp_path, "dir", cfg0, lambda p: shutil.copytree(
        jax_dir, orbax_checkpoint_path(p, 0)))
    (s_pt, best_pt, tr_pt), (s_dir, best_dir, tr_dir) = from_pt, from_dir
    assert tr_dir.history == tr_pt.history and len(tr_dir.history["train_losses"]) == 2
    assert s_dir.step == s_pt.step == 2 and s_dir.digest() == s_pt.digest()
    assert all(torch.equal(best_dir[k], best_pt[k]) for k in best_pt)
    a, b = s_dir.optimizer.state_dict()["state"], s_pt.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i][k], b[i][k]) for i in b for k in b[i])


def test_save_orbax_is_read_by_the_jax_package(exported, tmp_path):
    cfg = TrainConfig(img_wh=IMG, batch_size=4, lr=LR)
    model, _, state, train_step, _ = build_training(cfg, exported["tassets"], device="cpu")
    from straps_tpu_torch.train.synthetic import draw_synthetic
    draws = draw_synthetic(torch.Generator().manual_seed(0), 4, exported["tassets"].num_verts,
                           cfg, "cpu")
    train_step(state, draws, torch.zeros(4, 72), 0.3 * torch.ones(4, 10))   # non-zero moments
    best = params_to_host(model)
    metrics = {"pves_pa": 0.5, "mpjpes_pa": float("inf")}
    port_dir = str(tmp_path / "port_epoch4")
    save_orbax_checkpoint(port_dir, state, epoch=4, best_epoch=3, best_params=best,
                          best_epoch_val_metrics=metrics, heatmap_mode="clean")

    template = _load_tool().state_template(_jax_config())
    restored = jax_restore(port_dir, template)
    assert int(restored["epoch"]) == 4 and int(restored["best_epoch"]) == 3
    assert bytes(restored["meta"]["heatmap_mode"]).decode() == "clean"
    jstate = restored["state"]
    assert int(jstate.step) == 1 and int(jstate.opt_state[0].count) == 1
    back = load_checkpoint(port_dir, task_order=cfg.losses_on)
    want = state.state_dict()
    for k, v in want["model"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back["state"]["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(back["state"]["optimizer"]["state"][i][k], s[k]), (i, k)
    assert all(torch.equal(back["best_params"][k], v) for k, v in best.items())
    assert back["best_epoch_val_metrics"] == metrics and back["meta"] == {"heatmap_mode": "clean"}
    _assert_trees_equal(restore_checkpoint(port_dir), ocp.PyTreeCheckpointer().restore(port_dir))

    # A JAX save of the same tree holds the same keys and the same values.
    jax_dir = str(tmp_path / "jax_epoch4")
    jax_save(jax_dir, jstate, epoch=4, best_epoch=3, best_params=restored["best_params"],
             best_epoch_val_metrics={k: float(v) for k, v in
                                     restored["best_epoch_val_metrics"].items()},
             heatmap_mode="clean")
    assert sorted(_kvstore(port_dir).list().result()) == sorted(_kvstore(jax_dir).list().result())
    _assert_trees_equal(restore_checkpoint(port_dir), restore_checkpoint(jax_dir))
    with open(os.path.join(port_dir, "_METADATA")) as f, \
            open(os.path.join(jax_dir, "_METADATA")) as g:
        assert json.load(f) == json.load(g)
    shutil.rmtree(port_dir)                                   # ~190 MB each
    shutil.rmtree(jax_dir)


def _jax_config():
    from straps_tpu.config import TrainConfig as JaxTrainConfig
    return JaxTrainConfig(img_wh=IMG)


def _refused(tmp_path, tree, name="ckpt", zarray=None):
    path = str(tmp_path / name)
    write_tree(path, tree)
    if zarray is not None:                     # rewrite one array's .zarray
        reader = ocdbt.OcdbtReader(path)
        items = {k: reader.read(k) for k in reader.list()}
        key = next(k for k in items if k.endswith(b"/.zarray"))
        items[key] = json.dumps({**json.loads(items[key]), **zarray}).encode()
        shutil.rmtree(os.path.join(path, "d"))
        ocdbt.write_database(path, items)
    return path


def test_refusals_name_the_cause(tmp_path):
    """Other compressors and codecs, a missing `_METADATA`, a corrupt node
    and numbered manifests are refused by name; bfloat16 leaves and zarr3
    checkpoints, refused before, are read."""
    tree = {"a": np.arange(6, dtype=np.float32)}
    with pytest.raises(ValueError, match="gzip"):
        restore_checkpoint(_refused(tmp_path, tree, "gz", {"compressor": {"id": "gzip"}}))
    with pytest.raises(ValueError, match="blosc"):
        restore_checkpoint(_refused(tmp_path, tree, "blosc", {"compressor": {"id": "blosc"}}))
    # bfloat16: the 16 bits of each value, read as a torch.bfloat16 tensor.
    bits = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    bf = str(tmp_path / "bf")
    write_layout(bf, {"a": bits}, zarr3=False, use_ocdbt=True)
    got = restore_checkpoint(bf)["a"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, bits)
    with pytest.raises(ValueError, match="not written"):
        write_tree(str(tmp_path / "bf16"), {"a": np.zeros(3, np.float16)})
    # zarr3: read; a codec it does not know (and crc32c as an array codec)
    # is refused by name.
    z3 = str(tmp_path / "z3")
    write_layout(z3, tree, zarr3=True, use_ocdbt=True)
    assert restore_checkpoint(z3)["a"].tobytes() == tree["a"].tobytes()
    for codec in ("gzip", "transpose", "crc32c"):
        reader = ocdbt.OcdbtReader(z3)
        items = {k: reader.read(k) for k in reader.list()}
        meta = json.loads(items[b"a/zarr.json"])
        meta["codecs"] = meta["codecs"] + [{"name": codec}]
        bad = str(tmp_path / f"z3_{codec}")
        shutil.copytree(z3, bad)
        shutil.rmtree(os.path.join(bad, "d"))
        ocdbt.write_database(bad, {**items, b"a/zarr.json": json.dumps(meta).encode()})
        with pytest.raises(ValueError, match=f"codec '{codec}' is not read"):
            restore_checkpoint(bad)
    with pytest.raises(ValueError, match="_METADATA"):
        restore_checkpoint(str(tmp_path))
    # A flipped byte in the manifest fails its CRC-32C.
    bad = _refused(tmp_path, tree, "crc")
    manifest = os.path.join(bad, "manifest.ocdbt")
    raw = bytearray(open(manifest, "rb").read())
    raw[20] ^= 1
    open(manifest, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        restore_checkpoint(bad)
    # A numbered manifest (kind 1) is refused by name.
    num = _refused(tmp_path, tree, "numbered")
    manifest = os.path.join(num, "manifest.ocdbt")
    body = ocdbt._decode(open(manifest, "rb").read(), ocdbt.MANIFEST_MAGIC, "m").data
    body = body[:16] + b"\x01" + body[17:]
    open(manifest, "wb").write(ocdbt._encode(body, ocdbt.MANIFEST_MAGIC))
    with pytest.raises(ValueError, match="numbered manifests"):
        restore_checkpoint(num)
