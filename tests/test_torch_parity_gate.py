"""The port's real-assets acceptance gate (`straps_tpu_torch.cli.
run_parity_gate`) held against the JAX gate on the same stand-ins written
in the real on-disk formats: the reference `additional/` directory
(`write_reference_additional_dir`), a reference `.tar` from
`flax_to_torch_state_dict`, detectron2 pickles of the full-width torch
twins (`tests/torch_twin_d2.py`) and 2 cached proxies, at `--img-wh 64`.

Both gates print the same rows with the same statuses and details; with
float32 encoders in both packages the port's gate, with `--expected` set
to the JAX gate's outputs, passes at its own tolerances (PVE <= 1 mm,
betas 1e-2, rotation matrices and cameras 1e-3), so the two packages agree
through the gate.  At the gates' bfloat16 default the outputs are printed,
not held to 1 mm (see the test).  A 5 mm perturbation of the
expected vertices, a missing SMPL directory and a pickle short of one
backbone tensor each give FAIL and exit code 1.  The detector rows'
tensor counts equal the leaves of the JAX package's conversion of the same
pickles (the JAX gate's own detector rows, which build each model at
full width, are the JAX suite's `tests/test_parity_gate.py`).  Where the
JAX gate raises (a forward that fails after a load) or counts a stale
`*_verts.npy` of an earlier run as its own, the port's gate reports a
FAIL row and exit 1, or counts only this run's files (ROADMAP §3).
"""

import os
import pickle
import re
import shutil

import numpy as np
import pytest

from straps_tpu.cli.run_parity_gate import main as jax_gate
from straps_tpu.perception.convert_d2 import convert_d2_state
from straps_tpu.smpl.fixtures import generate_synthetic_smpl_arrays
from straps_tpu_torch.cli.run_parity_gate import main as port_gate
from test_parity_gate import _write_cached_proxies, _write_reference_tar
from test_real_asset_formats import write_reference_additional_dir
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROW = re.compile(r"^(\S+)\s+(PASS|FAIL)\s+(.*?)\s{2,}(\S.*)$")


def _rows(text):
    """The gate table's rows: {name: (status, detail)}."""
    rows = {}
    for line in text.splitlines():
        m = ROW.match(line)
        if m and m.group(1) != "gate":
            rows[m.group(1)] = (m.group(2), m.group(3).strip())
    return rows


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    arrs = generate_synthetic_smpl_arrays(seed=0)
    smpl_dir = write_reference_additional_dir(root / "additional", arrs)
    tar = root / "straps_model_checkpoint.tar"
    _write_reference_tar(tar, arrs)
    proxies = str(root / "proxies")
    _write_cached_proxies(proxies)
    common = ["--smpl-dir", smpl_dir, "--checkpoint", str(tar), "--input", proxies,
              "--img-wh", "64"]
    return root, common


@pytest.fixture()
def float32_encoders(monkeypatch):
    """Both packages' `PredictConfig` with the float32 encoder
    (`model.compute_dtype=None`) in place of the bfloat16 default."""
    import straps_tpu.config as jax_config
    import straps_tpu_torch.config as port_config

    def patch(module):
        make = module.PredictConfig

        def float32_config(*args, **kwargs):
            cfg = make(*args, **kwargs)
            cfg.model.compute_dtype = None
            return cfg
        monkeypatch.setattr(module, "PredictConfig", float32_config)
    patch(jax_config)
    patch(port_config)


def _pve_mm(a_dir, b_dir):
    names = sorted(f for f in os.listdir(a_dir) if f.endswith("_verts.npy"))
    return max(float(np.linalg.norm(np.load(os.path.join(a_dir, f))
                                    - np.load(os.path.join(b_dir, f)), axis=-1).mean() * 1e3)
               for f in names)


ROWS = ["smpl_assets_load", "smpl_forward_oracle", "regressor_checkpoint", "regressor_roundtrip",
        "demo_predict"]


def _both_gates(common, root, tag, capsys):
    """Run the JAX gate and the port's on the same arguments: their rows
    and output directories."""
    jax_out, port_out = str(root / f"jax_{tag}"), str(root / f"port_{tag}")
    assert jax_gate(common + ["--out-dir", jax_out]) == 0
    want = _rows(capsys.readouterr().out)
    assert port_gate(common + ["--out-dir", port_out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    got = _rows(text)
    assert "PARITY GATE: PASS" in text
    assert list(got) == list(want) == ROWS
    for name in ROWS:
        assert got[name][0] == want[name][0] == "PASS", (name, got[name], want[name])
        if name != "smpl_forward_oracle":          # its detail is each one's error
            assert got[name][1] == want[name][1], (name, got[name], want[name])
    assert "heatmap_mode=legacy" in got["regressor_checkpoint"][1]
    return jax_out, port_out


def test_rows_agree_with_the_jax_gate_at_its_defaults(stand_ins, capsys):
    """At the gates' defaults (bfloat16 encoder) both print the same rows,
    statuses and details.  Their outputs are not held to the gate's 1 mm
    there: flax's BatchNorm runs in bfloat16 and the port's in float32
    (ROADMAP §3), and on this random regressor at 64² the two lie 2.03 mm
    PVE apart, the JAX outputs 1.05 mm from its own float32 outputs."""
    root, common = stand_ins
    jax_out, port_out = _both_gates(common, root, "bf16", capsys)
    print(f"bfloat16 encoders: port vs JAX gate outputs, worst PVE {_pve_mm(port_out, jax_out):.4g} mm")


def test_outputs_agree_with_the_jax_gate_in_float32(stand_ins, float32_encoders, capsys):
    """With float32 encoders in both packages the port's gate, given the
    JAX gate's outputs as `--expected`, passes at the gate's tolerances
    (measured: 7.9e-4 mm PVE); a 5 mm perturbation of them fails."""
    root, common = stand_ins
    jax_out, port_out = _both_gates(common, root, "f32", capsys)
    assert port_gate(common + ["--out-dir", port_out, "--device", "cpu",
                               "--expected", jax_out]) == 0
    text = capsys.readouterr().out
    got = _rows(text)
    assert "PARITY GATE: PASS" in text
    pve = float(re.search(r"worst ([0-9.e+-]+) mm", got["expected_verts"][1]).group(1))
    print(f"float32 encoders: port gate vs the JAX gate's outputs, worst PVE {pve:.4g} mm")
    assert pve <= 1.0
    for name in ("expected_verts", "expected_shape", "expected_pose_rotmats", "expected_cam_wp"):
        assert got[name][0] == "PASS" and got[name][1].startswith("2 files"), (name, got[name])
    # A 5 mm perturbation of the expected vertices breaches the 1 mm PVE.
    perturbed = str(root / "perturbed")
    shutil.copytree(jax_out, perturbed)
    for f in sorted(os.listdir(perturbed)):
        if f.endswith("_verts.npy"):
            p = os.path.join(perturbed, f)
            np.save(p, np.load(p) + np.float32(0.005))
    assert port_gate(common + ["--out-dir", port_out, "--device", "cpu",
                               "--expected", perturbed]) == 1
    text = capsys.readouterr().out
    assert _rows(text)["expected_verts"][0] == "FAIL" and "PARITY GATE: FAIL" in text


def test_missing_smpl_directory_fails(tmp_path, capsys):
    rc = port_gate(["--smpl-dir", str(tmp_path / "nowhere"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 1 and "PARITY GATE: FAIL" in text
    status, detail = _rows(text)["smpl_assets_load"]
    assert status == "FAIL" and "fell back to synthetic fixture" in detail
    assert jax_gate(["--smpl-dir", str(tmp_path / "nowhere")]) == 1
    assert _rows(capsys.readouterr().out)["smpl_assets_load"] == (status, detail)


def test_orbax_directory_names_the_export_tool(stand_ins, tmp_path, capsys):
    """The port reads the JAX package's orbax directories itself now
    (`tests/test_torch_orbax.py` gates one against the JAX gate), so the
    export tool is no longer named: a directory that is no orbax
    checkpoint is a FAIL row naming what it lacks."""
    root, common = stand_ins
    orbax = tmp_path / "straps_model_checkpoint_epoch0"
    orbax.mkdir()
    rc = port_gate(["--smpl-dir", common[1], "--checkpoint", str(orbax), "--device", "cpu"])
    status, detail = _rows(capsys.readouterr().out)["regressor_checkpoint"]
    assert rc == 1 and status == "FAIL" and "_METADATA" in detail
    assert "tools/export_jax_checkpoint.py" not in detail


def test_detector_pickles_map_onto_the_detectors(stand_ins, tmp_path, capsys):
    """The three detectron2 pickles (the full-width twins' state in the
    zoo's {'model': ...} format) map onto the port's detectors: every
    tensor with its shape, as many as the JAX package converts; one
    backbone tensor dropped gives FAIL."""
    from torch_twin_d2 import (
        D2DensePoseRCNNTwin, D2KeypointRCNNTwin, D2PointRendRCNNTwin, twin_state_to_d2,
    )
    root, common = stand_ins
    flags, counts, states = [], {}, {}
    try:
        for flag, twin, row in [("--keypoint-checkpoint", D2KeypointRCNNTwin, "keypoint_rcnn_convert"),
                                ("--silhouette-checkpoint", D2PointRendRCNNTwin, "pointrend_convert"),
                                ("--densepose-checkpoint", D2DensePoseRCNNTwin, "densepose_convert")]:
            path = tmp_path / f"{row}.pkl"
            states[row] = twin_state_to_d2(twin())
            with open(path, "wb") as f:
                pickle.dump({"model": states[row], "__author__": "Detectron2 Model Zoo"}, f,
                            protocol=2)
            flags += [flag, str(path)]
            converted = convert_d2_state(states[row])       # the JAX package's load_d2_pkl
            counts[row] = sum(len(list(_leaves(converted[c]))) for c in ("params", "batch_stats"))
        rc = port_gate(["--smpl-dir", common[1], "--device", "cpu"] + flags)
        text = capsys.readouterr().out
        rows = _rows(text)
        assert rc == 0 and "PARITY GATE: PASS" in text, text
        for row, n in counts.items():
            assert rows[row] == ("PASS", f"{n} tensors structure+shape match"), (row, rows[row])
        # Drop a backbone tensor -> a missing tensor -> FAIL.
        state = dict(states["keypoint_rcnn_convert"])
        dropped = next(k for k in state if "backbone" in k and k.endswith("weight"))
        del state[dropped]
        bad = tmp_path / "bad.pkl"
        with open(bad, "wb") as f:
            pickle.dump({"model": state}, f, protocol=2)
        rc = port_gate(["--smpl-dir", common[1], "--device", "cpu",
                        "--keypoint-checkpoint", str(bad)])
        text = capsys.readouterr().out
        status, detail = _rows(text)["keypoint_rcnn_convert"]
        assert rc == 1 and status == "FAIL" and "1 missing" in detail and dropped in detail
        assert "PARITY GATE: FAIL" in text
    finally:
        for p in tmp_path.glob("*.pkl"):
            p.unlink()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_a_failing_forward_or_round_trip_is_a_fail_row(stand_ins, monkeypatch, capsys):
    """The JAX gate runs the regressor's forward, its flax round trip and
    the comparison outside its guard: a checkpoint that loads there but
    fails its forward (an R18 `.tar` under `--resnet-layers 50`) ends it
    with a traceback (ROADMAP §3).  The port's loader refuses that
    checkpoint itself; a forward or a round trip that fails after a load
    is a FAIL row naming the error, and exit code 1."""
    root, common = stand_ins
    wrong_depth = ["--smpl-dir", common[1], "--checkpoint", common[3], "--resnet-layers", "50"]
    with pytest.raises(Exception, match="shape"):
        jax_gate(wrong_depth)
    capsys.readouterr()
    assert port_gate(wrong_depth + ["--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert _rows(text)["regressor_checkpoint"][0] == "FAIL" and "size mismatch" in text

    from straps_tpu_torch.models import convert
    from straps_tpu_torch.models.regressor import SingleInputRegressor

    def fails(*args, **kwargs):
        raise RuntimeError("forward failed on purpose")
    gate = ["--smpl-dir", common[1], "--checkpoint", common[3], "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(SingleInputRegressor, "forward", fails)
        assert port_gate(gate) == 1
    text = capsys.readouterr().out
    rows = _rows(text)
    assert rows["regressor_checkpoint"] == ("FAIL", "RuntimeError: forward failed on purpose")
    assert "regressor_roundtrip" not in rows and "PARITY GATE: FAIL" in text
    with monkeypatch.context() as m:
        m.setattr(convert, "torch_state_dict_to_flax", fails)
        assert port_gate(gate) == 1
    rows = _rows(capsys.readouterr().out)
    assert rows["regressor_checkpoint"][0] == "PASS"
    assert rows["regressor_roundtrip"] == ("FAIL", "RuntimeError: forward failed on purpose")


def test_stale_outputs_are_not_counted(stand_ins, capsys):
    """A `*_verts.npy` left in `--out-dir` by an earlier run: the JAX gate
    counts it and reports a false FAIL (ROADMAP §3); the port's gate checks
    each predicted image's own file, and its row equals the JAX gate's row
    on a clean directory."""
    root, common = stand_ins
    jax_out, port_out, clean = (str(root / d) for d in ("jax_stale", "port_stale", "jax_clean"))
    for d in (jax_out, port_out):
        os.makedirs(d)
        np.save(os.path.join(d, "earlier_run_verts.npy"), np.zeros((6890, 3), np.float32))
    assert jax_gate(common + ["--out-dir", clean]) == 0
    want = _rows(capsys.readouterr().out)["demo_predict"]
    assert jax_gate(common + ["--out-dir", jax_out]) == 1
    jax_stale = _rows(capsys.readouterr().out)["demo_predict"]
    assert jax_stale == ("FAIL", "2 images -> 3 verts.npy, finite")
    assert port_gate(common + ["--out-dir", port_out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert _rows(text)["demo_predict"] == want == ("PASS", "2 images -> 2 verts.npy, finite")
    assert "PARITY GATE: PASS" in text
