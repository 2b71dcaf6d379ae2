"""One-command real-assets acceptance gate of the PyTorch port
(counterpart of `straps_tpu/cli/run_parity_gate.py`).

The day the reference's licensed assets are at hand (its
`run_predict.py:15-19`: `straps_model_checkpoint.tar`,
`additional/smpl/SMPL_*.pkl`, the detectron2 zoo pickles), this command
holds the port to them in one run: it loads the SMPL directory through the
real-format parsers, checks `smpl_forward` against an independent numpy
LBS oracle, converts the regressor checkpoint and round-trips it through
the flax layout, maps each detectron2 pickle onto its detector, runs the
demo predict, optionally diffs its outputs against a directory the
reference (or the JAX package) wrote, and prints a PASS/FAIL table with
named tolerances, exiting 1 on any FAIL:

    python -m straps_tpu_torch.cli.run_parity_gate \\
        --smpl-dir additional/smpl \\
        --checkpoint checkpoints/straps_model_checkpoint.tar \\
        --keypoint-checkpoint keypoint_rcnn_R_50_FPN.pkl \\
        --silhouette-checkpoint pointrend_rcnn_R_50_fpn.pkl \\
        --densepose-checkpoint densepose_rcnn_R_101_fpn_s1x.pkl \\
        --input demo_proxies/ --expected reference_outputs/

Rows, details, tolerances and exit codes are the JAX gate's, with two
repairs: a regressor forward or flax round trip that fails after the
checkpoint loaded is a FAIL row (the JAX gate raises there), and the
demo predict counts each predicted image's own `<name>_verts.npy`, not
every such file in `--out-dir` (the JAX gate counts an earlier run's
too).  Runs on CUDA unless `--device cpu` is given.  `--checkpoint` also
takes the JAX package's orbax checkpoint directories, read without JAX
(`utils/checkpoints.py`).  `tests/test_torch_parity_gate.py`
rehearses the gate on stand-ins written in the real formats and holds it
against the JAX gate.
"""

import argparse
import glob
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

# (name, status, detail, tolerance) rows for the final table.
GateRow = Tuple[str, bool, str, str]

PVE_TOL_MM = 1.0            # the north star: <= 1 mm PVE against the reference
ORACLE_TOL_M = 1e-4         # SMPL forward vs the independent numpy LBS: 0.1 mm
SHAPE_TOL = 1e-2            # max |delta beta|
POSE_TOL = 1e-3             # max |delta rotmat element|
CAM_TOL = 1e-3              # max |delta weak-perspective cam param|


def _numpy_lbs_oracle(assets, betas: np.ndarray, rotmats: np.ndarray) -> np.ndarray:
    """Independent single-sample SMPL LBS written from the paper's
    equations (Loper et al. 2015, eq. 1-7) in float64 numpy, kept in the
    gate so that it stands alone without the tests."""
    def host(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64)

    v_template = host(assets.v_template)
    shapedirs = host(assets.shapedirs)
    posedirs = host(assets.posedirs)
    J_reg = host(assets.J_regressor)
    W = host(assets.lbs_weights)
    parents = np.asarray(assets.parents)

    v_shaped = v_template + shapedirs @ np.asarray(betas, np.float64)
    J = J_reg @ v_shaped
    pose_feat = (np.asarray(rotmats, np.float64)[1:] - np.eye(3)).reshape(-1)
    v_posed = v_shaped + (pose_feat @ posedirs).reshape(-1, 3)

    G = np.zeros((24, 4, 4))
    G[0] = np.eye(4)
    G[0, :3, :3] = rotmats[0]
    G[0, :3, 3] = J[0]
    for j in range(1, 24):
        local = np.eye(4)
        local[:3, :3] = rotmats[j]
        local[:3, 3] = J[j] - J[parents[j]]
        G[j] = G[parents[j]] @ local
    A = G.copy()
    for j in range(24):
        A[j, :3, 3] -= G[j, :3, :3] @ J[j]
    T = np.einsum("vj,jpq->vpq", W, A)
    return np.einsum("vpq,vq->vp", T[:, :3, :3], v_posed) + T[:, :3, 3]


def gate_smpl_assets(smpl_dir: Optional[str], device, rows: List[GateRow]):
    """Load the SMPL directory through every real-format parser
    (`smpl/assets.py::load_assets`: the chumpy-stripped pkl, the regressor
    npys, the mean-params npz, the colour-cube parts)."""
    from straps_tpu_torch.smpl.assets import load_assets

    try:
        assets = load_assets(smpl_dir, device=device)
    except Exception as e:  # noqa: BLE001 - the gate reports, never raises
        rows.append(("smpl_assets_load", False, f"{type(e).__name__}: {e}", "loads"))
        return None
    if smpl_dir is not None and assets.is_synthetic:
        # load_assets falls back to the synthetic fixture when the pkl is
        # absent: a convenience for the library, a FAIL for a gate pointed
        # at a real directory.
        rows.append(("smpl_assets_load", False,
                     f"no SMPL_NEUTRAL.pkl under {smpl_dir} (fell back to synthetic fixture)",
                     "loads"))
        return None
    leaves = [assets.v_template, assets.shapedirs, assets.posedirs, assets.J_regressor,
              assets.lbs_weights, assets.J_regressor_extra, assets.J_regressor_cocoplus,
              assets.J_regressor_h36m]
    finite = all(bool(x.isfinite().all()) for x in leaves)
    detail = f"V={assets.num_verts} F={assets.faces.shape[0]} synthetic={assets.is_synthetic}"
    rows.append(("smpl_assets_load", finite, detail, "loads, all finite"))
    return assets


def gate_smpl_oracle(assets, rows: List[GateRow]) -> float:
    """`smpl_forward` on the loaded assets, on their device, against the
    numpy LBS oracle at a fixed nontrivial pose (seed 11).  Returns the
    largest vertex error in metres."""
    import torch
    from scipy.spatial.transform import Rotation as ScipyRotation

    from straps_tpu_torch.smpl.model import smpl_forward

    rng = np.random.RandomState(11)
    betas = rng.randn(10).astype(np.float32) * 0.5
    aa = rng.randn(24, 3).astype(np.float32) * 0.3
    rotmats = ScipyRotation.from_rotvec(aa).as_matrix().astype(np.float32)

    dev = assets.device
    out = smpl_forward(assets, torch.as_tensor(betas, device=dev)[None],
                       torch.as_tensor(rotmats[1:], device=dev)[None],
                       torch.as_tensor(rotmats[0:1], device=dev)[None])
    want = _numpy_lbs_oracle(assets, betas, rotmats)
    err_m = float(np.abs(out.vertices[0].detach().cpu().numpy() - want).max())
    rows.append(("smpl_forward_oracle", err_m <= ORACLE_TOL_M, f"max vertex err {err_m:.2e} m",
                 f"<= {ORACLE_TOL_M:.0e} m"))
    return err_m


def _flax_leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flax_leaves(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


def gate_regressor_checkpoint(checkpoint: Optional[str], assets, resnet_layers: int,
                              rows: List[GateRow]) -> None:
    """Load the reference `.tar` (or a port `.pt`, or the JAX package's
    orbax directory) through the predict
    path's loader, run a forward on zeros at 256², and round-trip the
    weights through the flax layout (`models/convert.py`) exactly.  A
    failure in any of the three is a FAIL row, never a raise."""
    import torch

    from straps_tpu_torch.config import PredictConfig
    from straps_tpu_torch.predict.pipeline import load_regressor_variables

    if checkpoint is None:
        rows.append(("regressor_checkpoint", True, "skipped (not provided)", "-"))
        return
    cfg = PredictConfig(checkpoint=checkpoint)
    cfg.model.resnet_layers = resnet_layers
    try:
        # The pipeline's own loader: reference .tar -> best_model_state_dict,
        # the port's .pt or a JAX orbax directory -> best parameters (+ heatmap
        # mode).
        model, mode = load_regressor_variables(cfg, assets, device=assets.device)
    except Exception as e:  # noqa: BLE001
        rows.append(("regressor_checkpoint", False, f"{type(e).__name__}: {e}", "converts"))
        return
    try:
        with torch.no_grad():
            out = model(torch.zeros(1, 256, 256, 18, device=assets.device))
        finite = all(bool(o.isfinite().all()) for o in out)
    except Exception as e:  # noqa: BLE001
        rows.append(("regressor_checkpoint", False, f"{type(e).__name__}: {e}",
                     "converts, forward finite"))
        return
    n_params = sum(p.numel() for p in model.parameters())
    rows.append(("regressor_checkpoint", finite,
                 f"{n_params / 1e6:.1f}M params, heatmap_mode={mode}, forward finite",
                 "converts, forward finite"))
    try:
        ok, n = _flax_round_trip(model)
        detail = f"{n} tensors bit-identical" if ok else "mismatch"
    except Exception as e:  # noqa: BLE001
        ok, detail = False, f"{type(e).__name__}: {e}"
    rows.append(("regressor_roundtrip", ok, detail, "flax->torch->flax exact"))


def _flax_round_trip(model) -> Tuple[bool, int]:
    """Lossless round trip: flax layout -> torch state dict -> flax layout,
    and the torch tensors it carries back.  Returns (exact, tensor count)."""
    from straps_tpu_torch.models.convert import (
        flax_to_torch_state_dict, torch_state_dict_to_flax,
    )

    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    flax = torch_state_dict_to_flax(state)
    back_state = flax_to_torch_state_dict(flax)
    back = torch_state_dict_to_flax(back_state)
    want = list(_flax_leaves({k: flax[k] for k in ("params", "batch_stats")}))
    got = list(_flax_leaves({k: back[k] for k in ("params", "batch_stats")}))
    ok = len(want) == len(got) and all(
        pw == pg and vw.dtype == vg.dtype and np.array_equal(vw, vg)
        for (pw, vw), (pg, vg) in zip(want, got))
    ok = ok and all(np.array_equal(back_state[k], state[k]) for k in back_state
                    if not k.endswith("num_batches_tracked"))
    return ok, len(want)


def gate_detector_checkpoint(path: Optional[str], model_cls, name: str, device,
                             rows: List[GateRow]) -> None:
    """Map a detectron2 pickle onto its detector, built on the `meta`
    device: every parameter and buffer of the model present with its shape,
    and no tensor of the pickle under the model's modules left over (the
    conversion-coverage check, without an 800² forward)."""
    import torch

    from straps_tpu_torch.perception.convert_d2 import load_d2_pkl, load_detector_state

    if path is None:
        rows.append((name, True, "skipped (not provided)", "-"))
        return
    try:
        state = load_d2_pkl(path)
    except Exception as e:  # noqa: BLE001
        rows.append((name, False, f"{type(e).__name__}: {e}", "converts"))
        return
    with torch.device("meta"):
        model = model_cls()
    want = model.state_dict()
    modules = {m for m, _ in model.named_modules()}
    missing = [k for k in want if k not in state]
    wrong = [k for k in want if k in state and tuple(state[k].shape) != tuple(want[k].shape)]
    extra = [k for k in state if k not in want and k.rsplit(".", 1)[0] in modules]
    ok = not (missing or wrong or extra)
    if ok:
        try:
            load_detector_state(model, state, device)
        except Exception as e:  # noqa: BLE001
            ok, bad = False, f"{type(e).__name__}: {e}"
    else:
        bad = (f"{len(missing)} missing (e.g. {missing[:1]}), {len(wrong)} of a wrong shape "
               f"(e.g. {wrong[:1]}), {len(extra)} left over (e.g. {extra[:1]})")
    rows.append((name, ok, f"{len(want)} tensors structure+shape match" if ok else bad,
                 "tree == model.init"))


def gate_demo_predict(cfg, device, rows: List[GateRow]):
    """Run the whole predict pipeline (the reference's `run_predict.py`
    surface), renders off, and require a finite `<name>_verts.npy` on disk
    for each predicted image (other files in `out_dir`, from an earlier
    run, are not counted)."""
    from straps_tpu_torch.predict.pipeline import predict_3d

    try:
        out = predict_3d(cfg, save_vis=False, device=device)
    except Exception as e:  # noqa: BLE001
        rows.append(("demo_predict", False, f"{type(e).__name__}: {e}", "runs"))
        return None
    finite = all(bool(np.all(np.isfinite(np.asarray(out[k]))))
                 for k in ("verts", "shape", "pose_rotmats", "cam_wp"))
    n_npy = sum(_finite_npy(os.path.join(cfg.out_dir, f"{name}_verts.npy"))
                for name in out["names"])
    rows.append(("demo_predict", finite and n_npy == len(out["names"]),
                 f"{len(out['names'])} images -> {n_npy} verts.npy, finite",
                 "runs, outputs finite"))
    return out


def _finite_npy(path: str) -> bool:
    try:
        return bool(np.isfinite(np.load(path)).all())
    except (OSError, ValueError):
        return False


def gate_expected_outputs(out_dir: str, expected_dir: str, rows: List[GateRow]) -> None:
    """Diff the predict outputs against a directory the reference wrote
    (`<name>_verts.npy`, `_shape`, `_pose_rotmats`, `_cam_wp`; its
    `predict/predict_3D.py:157-183`): mean per-vertex error in mm, the
    others' largest absolute difference."""
    specs = [("verts", PVE_TOL_MM, "pve_mm"), ("shape", SHAPE_TOL, "max_abs"),
             ("pose_rotmats", POSE_TOL, "max_abs"), ("cam_wp", CAM_TOL, "max_abs")]
    for suffix, tol, kind in specs:
        exp_files = sorted(glob.glob(os.path.join(expected_dir, f"*_{suffix}.npy")))
        if not exp_files:
            rows.append((f"expected_{suffix}", True, "skipped (no files in --expected)", "-"))
            continue
        worst, missing = 0.0, 0
        for ef in exp_files:
            ours = os.path.join(out_dir, os.path.basename(ef))
            if not os.path.exists(ours):
                missing += 1
                continue
            want, got = np.load(ef), np.load(ours)
            if want.shape != got.shape:
                missing += 1
                continue
            if kind == "pve_mm":
                err = float(np.linalg.norm(got - want, axis=-1).mean() * 1e3)
            else:
                err = float(np.abs(got - want).max())
            worst = max(worst, err)
        unit = " mm" if kind == "pve_mm" else ""
        ok = missing == 0 and worst <= tol
        detail = (f"{len(exp_files)} files, worst {worst:.4g}{unit}"
                  + (f", {missing} missing/mismatched" if missing else ""))
        rows.append((f"expected_{suffix}", ok, detail, f"<= {tol}{unit}"))


def print_table(rows: List[GateRow]) -> bool:
    name_w = max(len(r[0]) for r in rows)
    det_w = max(len(r[2]) for r in rows)
    print(f"{'gate':<{name_w}}  status  {'detail':<{det_w}}  tolerance")
    print("-" * (name_w + det_w + 30))
    all_ok = True
    for name, ok, detail, tol in rows:
        all_ok = all_ok and ok
        print(f"{name:<{name_w}}  {'PASS' if ok else 'FAIL':<6}  {detail:<{det_w}}  {tol}")
    print("-" * (name_w + det_w + 30))
    print("PARITY GATE:", "PASS" if all_ok else "FAIL")
    return all_ok


def build_parser():
    p = argparse.ArgumentParser(description="Real-assets acceptance gate: convert + verify parity")
    p.add_argument("--smpl-dir", default=None,
                   help="reference additional/smpl directory (synthetic fixture when omitted)")
    p.add_argument("--checkpoint", default=None,
                   help="reference straps_model_checkpoint.tar, a training checkpoint .pt "
                        "of the port, or an orbax checkpoint directory of the JAX package")
    p.add_argument("--keypoint-checkpoint", default=None, help="detectron2 Keypoint-RCNN pkl")
    p.add_argument("--silhouette-checkpoint", default=None, help="detectron2 PointRend pkl")
    p.add_argument("--densepose-checkpoint", default=None, help="detectron2 DensePose R101 pkl")
    p.add_argument("--input", default=None,
                   help="demo input dir (cached proxies or images); demo predict is skipped "
                        "when omitted")
    p.add_argument("--silh-from", default="cached", choices=["cached", "pointrend", "densepose"])
    p.add_argument("--expected", default=None,
                   help="reference-generated output dir to diff against (<name>_verts.npy etc.)")
    p.add_argument("--out-dir", default="parity_gate_out")
    p.add_argument("--img-wh", type=int, default=256)
    p.add_argument("--resnet-layers", type=int, default=18)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> int:
    from straps_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rows: List[GateRow] = []

    assets = gate_smpl_assets(args.smpl_dir, device, rows)
    if assets is not None:
        gate_smpl_oracle(assets, rows)
        gate_regressor_checkpoint(args.checkpoint, assets, args.resnet_layers, rows)

    if any([args.keypoint_checkpoint, args.silhouette_checkpoint, args.densepose_checkpoint]):
        from straps_tpu_torch.perception import rcnn

        gate_detector_checkpoint(args.keypoint_checkpoint, rcnn.KeypointRCNN,
                                 "keypoint_rcnn_convert", device, rows)
        gate_detector_checkpoint(args.silhouette_checkpoint, rcnn.PointRendRCNN,
                                 "pointrend_convert", device, rows)
        gate_detector_checkpoint(args.densepose_checkpoint, rcnn.DensePoseRCNN,
                                 "densepose_convert", device, rows)

    if args.input is not None and assets is not None:
        from straps_tpu_torch.config import PredictConfig

        silhouette = {"pointrend": args.silhouette_checkpoint,
                      "densepose": args.densepose_checkpoint}.get(args.silh_from,
                                                                 args.silhouette_checkpoint)
        cfg = PredictConfig(input_dir=args.input, checkpoint=args.checkpoint,
                            silhouettes_from=args.silh_from, out_dir=args.out_dir,
                            smpl_dir=args.smpl_dir, img_wh=args.img_wh,
                            keypoint_checkpoint=args.keypoint_checkpoint,
                            silhouette_checkpoint=silhouette)
        cfg.model.resnet_layers = args.resnet_layers
        out = gate_demo_predict(cfg, device, rows)
        if out is not None and args.expected is not None:
            gate_expected_outputs(args.out_dir, args.expected, rows)
    elif args.expected is not None:
        rows.append(("expected_outputs", False,
                     "--expected given but no --input to predict from", "-"))

    return 0 if print_table(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
