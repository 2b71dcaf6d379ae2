#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`straps_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles both rasteriser kernels from `straps_tpu_torch/csrc`
     (each `.cu` with the shared `raster_span.cuh`), one nvcc each,
     started together;
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, bit for bit (packed keys; face ids and depths): two triangles;
     the synthetic SMPL mesh at 256x256, B=8 and B=32, culled and not, a
     ragged 250x250 and a 512x512 of two 256-column tiles; the scenes of
     `tests/raster_scenes.py` (wide triangles across tile edges, ragged
     widths, near-horizontal edges, vertices on pixel centres, special
     planes, a coplanar depth tie across two chunks);
  4. slices, each with every kernel's launch count set to 0 just before it
     and read just after:
     - the evaluation CLI on 64 synthetic samples at full width (256x256
       proxies, ResNet-18 + IEF, the 13776-face mesh, batch 32, bfloat16
       encoder, the IEF head set to the T-pose so the predicted body fills
       the crop); metrics finite, IoU in (0.2, 1], and the packed kernel's
       launch count shows every render went through it; then the same
       evaluation at 64x64 in float32 on the card and on the CPU, which
       must agree;
     - the predict CLI over 64 cached proxies (512x512 silhouettes and 17
       joints of synthetic bodies) with the same checkpoint, at 256x256:
       npy outputs finite, every render has foreground, and exactly 2
       face-id kernel launches (all rend renders, all reposed renders);
       the face-id kernel held against its plain version, bit for bit, on
       the inputs of those two launches (B=64, 256x256, unculled); then
       the same predict at 64x64 in float32 on the card and on the CPU,
       which must agree;
  5. times: each kernel at B=64, 256x256 (packed: culled eval bodies;
     face-id: unculled, the predict renders' own bodies), beside its bound
     and its plain version; the evaluation's and the predict's wall time;
     proxy -> SMPL inferences/s at batch 256.
The card's name and power limit come two lines before the last, the
`kernels` JSON on the line before the last, the result JSON last.
Exits non-zero without a card, and outside a checkout of the repository.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# FP32 outside the tensor cores: 67 TFLOP/s on the data sheet (SXM) counts
# an FMA as 2; the kernels forbid FMA, so each product and each sum is one
# instruction at half that rate.
H100_FP32_UNFUSED_OPS = 33.5e12
H100_HBM_BYTES_S = 3.35e12
OPS_PER_PIXEL_FACE = 6        # 3 edge planes x (a*x, + (b*y + c))
OPS_PER_ROW_FACE = 6          # 3 edge planes x (b*y, + c): shared by a pixel row
OPS_PER_COVERED = 4           # the depth plane, on covered pixels only


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn()` over `reps` runs after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smpl_kernel_inputs(assets, img_wh, B, seed, cull=True):
    """Kernel inputs of B posed synthetic bodies seen as the eval renders
    its ground truth."""
    from straps_tpu_torch.geometry.camera import get_intrinsics_matrix
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.render import raster as R
    from straps_tpu_torch.smpl.model import smpl_forward_axis_angle

    dev = assets.device
    g = torch.Generator().manual_seed(seed)
    poses = (torch.randn(B, 72, generator=g) * 0.2).to(dev)
    shapes = (torch.randn(B, 10, generator=g) * 0.5).to(dev)
    verts = smpl_forward_axis_angle(assets, shapes, poses).vertices
    K = torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, 5000.0 * img_wh / 256),
                        device=dev)
    cam_t = torch.tensor([0.0, 0.2, 42.0], device=dev).expand(B, 3)
    screen, z = R.project_to_screen(verts, cam_t, K)
    planes = R.prepare_face_planes(screen, z, assets.faces)
    dead = R.backface_mask(screen, assets.faces) if cull else None
    if cull:
        planes = R.kill_faces(planes, dead)
    bounds = R.face_chunk_row_bounds(screen, assets.faces, CR.FACE_CHUNK, img_wh,
                                     dead_mask=dead)
    flat, attr = CR.pack_planes(planes, assets.face_parts)
    return flat, bounds.contiguous(), attr


def compare_kernel(name, flat, bounds, attr, img_h, img_w):
    """Packed kernel vs its plain version on the same card inputs: the keys
    must be identical.  Returns the max absolute depth error where both
    cover (0 when they agree)."""
    from straps_tpu_torch.render import cuda_raster as CR

    got = CR.packed_raster_kernel(flat, bounds, attr, img_h, img_w)
    torch.cuda.synchronize()
    want = CR.rasterize_packed_reference(flat, bounds, attr, img_h, img_w)
    parts_k, z_k = CR.unpack_keys(got)
    parts_p, z_p = CR.unpack_keys(want)
    mismatch = (parts_k != parts_p).float().mean().item()
    both = (parts_k > 0) & (parts_p > 0)
    err = float((z_k - z_p).abs()[both].max().item()) if both.any() else 0.0
    fg = (parts_p > 0).float().mean().item()
    identical = torch.equal(got, want)
    print(f"kernel vs plain [{name}]: keys identical {identical} (part mismatch "
          f"{mismatch}, depth max abs error {err}), foreground {fg:.4f}")
    if fg <= 0.0:
        raise AssertionError(f"{name}: empty render")
    if not identical:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def compare_faceid(name, flat, bounds, img_h, img_w):
    """Face-id kernel vs its plain version on the same card inputs: face
    ids and depths must be identical.  Returns the max absolute depth error
    where both cover (0 when they agree)."""
    from straps_tpu_torch.render import cuda_raster as CR

    fid_k, z_k = CR.faceid_raster_kernel(flat, bounds, img_h, img_w)
    torch.cuda.synchronize()
    fid_p, z_p = CR.rasterize_faceid_reference(flat, bounds, img_h, img_w)
    mismatch = (fid_k != fid_p).float().mean().item()
    both = (fid_k >= 0) & (fid_p >= 0)
    err = float((z_k - z_p).abs()[both].max().item()) if both.any() else 0.0
    bg_ok = bool(((z_k == CR.FACEID_BG_DEPTH) == (fid_k < 0)).all().item())
    fg = (fid_p >= 0).float().mean().item()
    identical = torch.equal(fid_k, fid_p) and torch.equal(z_k, z_p)
    print(f"face-id kernel vs plain [{name}]: outputs identical {identical} (face-id "
          f"mismatch {mismatch}, depth max abs error {err}), foreground {fg:.4f}, "
          f"background depth 3.4e38 {bg_ok}")
    if fg <= 0.0 or not bg_ok:
        raise AssertionError(f"{name}: empty render or a wrong background depth")
    if not identical:
        raise AssertionError(f"{name}: face-id kernel disagrees with its plain version")
    return err


def covered_pixel_faces(flat, bounds, img_h, img_w):
    """Pixel-face pairs where the pixel centre lies inside the face: the
    pairs whose depth plane the kernel evaluates."""
    from straps_tpu_torch.render import cuda_raster as CR

    xs = torch.arange(img_w, dtype=torch.float32, device=flat.device) + 0.5
    ys = torch.arange(img_h, dtype=torch.float32, device=flat.device) + 0.5
    total = 0
    for c, (lo, hi) in enumerate(zip(bounds[..., 0].amin(0).tolist(),
                                      bounds[..., 1].amax(0).tolist())):
        if lo >= hi:
            continue
        p = flat[:, c * CR.FACE_CHUNK:(c + 1) * CR.FACE_CHUNK]
        y = ys[lo:hi][:, None]
        cov = None
        for k in (0, 3, 6):
            e = p[:, :, k, None, None] * xs + (p[:, :, k + 1, None, None] * y
                                               + p[:, :, k + 2, None, None])
            cov = e >= 0 if cov is None else cov & (e >= 0)
        total += int(cov.sum().item())
    return total


def kernel_bound_ms(flat, bounds, img_h, img_w, other_in_bytes, out_bytes_per_pixel):
    """Least time for a rasteriser kernel's work on these inputs: the
    larger of the bytes (inputs read once: planes, bounds and
    `other_in_bytes`; outputs written once, `out_bytes_per_pixel`) over HBM
    bandwidth and the unfused FP32 operations over their peak rate.  The
    operations are what the span kernels cannot skip: the three edges' row
    terms `b*y + c` of every (row, face) pair inside each chunk's own band,
    and the depth plane of every pair where the pixel is covered.  The
    dense count of the earlier per-pixel kernels (every pixel-face pair of
    every (8-row strip, chunk) whose band overlaps the strip) is printed
    the line before."""
    from straps_tpu_torch.render import cuda_raster as CR

    B = flat.shape[0]
    nbytes = (flat.numel() * 4 + bounds.numel() * 4 + other_in_bytes
              + B * img_h * img_w * out_bytes_per_pixel)
    covered = covered_pixel_faces(flat, bounds, img_h, img_w)
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3

    strip0 = torch.arange(0, img_h, CR.ROWS_PER_TILE, device=bounds.device)
    rows = torch.clamp(img_h - strip0, max=CR.ROWS_PER_TILE)           # (S,)
    lo, hi = bounds[..., 0, None], bounds[..., 1, None]                 # (B, C, 1)
    overlap = (lo < strip0 + CR.ROWS_PER_TILE) & (hi > strip0)         # (B, C, S)
    strip_row_faces = int((overlap * rows).sum().item()) * CR.FACE_CHUNK
    pixel_faces = strip_row_faces * img_w
    dense_ops = (pixel_faces * OPS_PER_PIXEL_FACE + strip_row_faces * OPS_PER_ROW_FACE
                 + covered * OPS_PER_COVERED)
    t_dense = dense_ops / H100_FP32_UNFUSED_OPS * 1e3
    print(f"kernel bound, dense count of the per-pixel kernels: {dense_ops} unfused FP32 ops "
          f"({pixel_faces} pixel-face pairs in {int(overlap.sum())} strip-chunk overlaps "
          f"x {OPS_PER_PIXEL_FACE}, {strip_row_faces} row-face pairs x {OPS_PER_ROW_FACE}, "
          f"{covered} covered x {OPS_PER_COVERED}) -> {t_dense:.4f} ms; bound "
          f"{max(t_dense, t_bytes):.4f} ms")

    band_row_faces = int((bounds[..., 1] - bounds[..., 0]).clamp(min=0).sum().item()) \
        * CR.FACE_CHUNK
    ops = band_row_faces * OPS_PER_ROW_FACE + covered * OPS_PER_COVERED
    t_ops = ops / H100_FP32_UNFUSED_OPS * 1e3
    print(f"kernel bound: {nbytes} bytes -> {t_bytes:.4f} ms; {ops} unfused FP32 ops "
          f"({band_row_faces} row-face pairs in the chunks' bands x {OPS_PER_ROW_FACE}, "
          f"{covered} covered x {OPS_PER_COVERED}) -> {t_ops:.4f} ms")
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def write_t_pose_checkpoint(path, assets, fc3_weight_scale=0.0):
    """A reference-format `.tar` of the seeded random regressor whose IEF
    head returns, near the mean shape in the T-pose at camera scale 0.9, a
    body that fills the crop (`fc3` bias set, its weight scaled by
    `fc3_weight_scale`: 0 gives the same body for every input, a small
    scale bodies that vary with it), so the silhouette IoU compares two
    non-empty renders.  The synthetic fixture's mean pose (1, 0, 0, 0, 1, 0)
    is degenerate under `rot6d_to_rotmat`'s (3, 2) reading; the identity is
    (1, 0, 0, 1, 0, 0)."""
    from straps_tpu_torch.config import PredictConfig
    from straps_tpu_torch.predict.pipeline import load_regressor_variables

    model, _ = load_regressor_variables(PredictConfig(), assets, device="cpu")
    ief = model.ief_module
    ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(24)
    with torch.no_grad():
        ief.fc3.weight.mul_(fc3_weight_scale)
        ief.fc3.bias.zero_()
        ief.fc3.bias[3:147] = (ident - ief.initial_estimate[3:147]) / ief.iterations
    torch.save({"best_model_state_dict": model.state_dict()}, path)


def vis_faceid_inputs(assets, verts, cam_wp, img_wh, rotate_x180=False):
    """The face-id kernel's inputs for `render_body_vis_batch` of these
    bodies: planes and unculled row bounds, the bodies rotated 180 degrees
    about x first with `rotate_x180`, as that function does."""
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.render import raster as R
    from straps_tpu_torch.render.vis import vis_camera

    dev = assets.device
    verts = torch.as_tensor(verts, device=dev).to(torch.float32)
    if rotate_x180:
        verts = verts * torch.tensor((1.0, -1.0, -1.0), device=dev)
    cam_t, K = vis_camera(torch.as_tensor(cam_wp, device=dev), img_wh)
    screen, z = R.project_to_screen(verts, cam_t, K)
    planes = R.prepare_face_planes(screen, z, assets.faces)
    bounds = R.face_chunk_row_bounds(screen, assets.faces, CR.FACE_CHUNK, img_wh)
    return CR.flatten_planes(planes), bounds.contiguous()


def decode_png(path):
    """Pixels of a PNG written by `straps_tpu_torch.utils.png` (8-bit,
    filter type 0 on every row) -> uint8 (H, W, channels)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = body
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big")
    channels = {0: 1, 2: 3, 6: 4}[header[9]]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, channels)


def reset_launches():
    from straps_tpu_torch.render import cuda_raster as CR
    for k in CR.KERNELS:
        k.launches = 0


def write_eval_npz(path, n, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, poses=(rng.randn(n, 72) * 0.2).astype(np.float32),
             shapes=(rng.randn(n, 10) * 0.5).astype(np.float32),
             genders=np.asarray(["n"] * n))


def profile_run(card, label, n, unit, run, top=10):
    """Wall time of `run()` twice (the second warm), then one profiled run:
    the device busy share, the entries with the most device time and the
    rasteriser kernels' entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"times on {card}: warm {label}: {walls[-1] * 1e3:.2f} ms wall "
          f"({n / walls[-1]:.2f} {unit}/s; first two runs {walls[0] * 1e3:.2f}, "
          f"{walls[1] * 1e3:.2f} ms)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # Device-side entries only (kernels, copies, memsets): host ops would
    # count their kernels a second time.
    events = sorted((e for e in prof.key_averages()
                     if getattr(e, "device_type", None) == DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    if busy_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile on {card}: {label} {wall_ms:.2f} ms wall under the profiler, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    # The entries with the most device time, and the rasteriser kernels'
    # wherever they rank.
    for e in events[:top] + [e for e in events[top:] if "span_raster" in e.key]:
        print(f"  {device_us(e) / 1e3:9.3f} ms {100 * device_us(e) / 1e3 / busy_ms:5.1f}%"
              f"  x{e.count:<5d} {e.key[:100]}")


def main() -> int:
    # 1. Device.
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    here = os.path.dirname(os.path.abspath(__file__))
    import straps_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(straps_tpu_torch.__file__))) != here:
        raise RuntimeError("chip_smoke.py must run from a checkout holding straps_tpu_torch/")
    from straps_tpu_torch.cli import run_eval, run_predict
    from straps_tpu_torch.config import PredictConfig
    from straps_tpu_torch.eval_harness.runner import run_evaluation, synthesise_proxy_inputs
    from straps_tpu_torch.predict.pipeline import (
        REPOSED_CAM_WP, load_regressor_variables, make_predict_fn, predict_3d, save_proxies,
    )
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.render import raster as R
    from straps_tpu_torch.smpl.assets import load_synthetic_assets
    from straps_tpu_torch.utils.device import resolve_device
    sys.path.insert(0, os.path.join(here, "tests"))
    from raster_scenes import KERNEL_SCENES

    dev = resolve_device("cuda")

    # 2. Build: one nvcc per kernel source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CR.KERNELS)) as pool:
        libs = list(pool.map(lambda k: CR.build_library(k.source), CR.KERNELS))
    for kernel in CR.KERNELS:
        kernel.function()
    print(f"build: {', '.join(libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        with open(lib + ".log") as f:
            print(f.read().strip())

    # 3. Kernels vs plain on the card.
    assets = load_synthetic_assets(device=dev)
    scr = torch.tensor([[8., 8.], [56., 8.], [8., 56.], [20., 20.], [44., 20.], [20., 44.]],
                       device=dev)
    zz = torch.tensor([10., 10., 10., 5., 5., 5.], device=dev)
    tri = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32, device=dev)
    flat, attr = CR.pack_planes(R.prepare_face_planes(scr[None], zz[None], tri),
                                torch.tensor([3, 5], device=dev))
    tri_bounds = R.face_chunk_row_bounds(scr[None], tri, CR.FACE_CHUNK, 64)
    errs = [compare_kernel("two triangles 64x64", flat, tri_bounds, attr, 64, 64)]
    faceid_errs = [compare_faceid("two triangles 64x64", flat, tri_bounds, 64, 64)]
    for B, wh, cull in ((8, 256, True), (32, 256, True), (8, 256, False), (8, 250, True),
                        (8, 512, True)):
        errs.append(compare_kernel(f"SMPL B={B} {wh}x{wh} cull={cull}",
                                   *smpl_kernel_inputs(assets, wh, B, seed=B + wh, cull=cull),
                                   wh, wh))
    for B, wh, cull in ((8, 256, False), (8, 256, True), (32, 256, False), (32, 256, True),
                        (8, 250, False), (8, 512, False)):
        flat, bounds, _ = smpl_kernel_inputs(assets, wh, B, seed=B + wh + 1, cull=cull)
        faceid_errs.append(compare_faceid(f"SMPL B={B} {wh}x{wh} cull={cull}",
                                          flat, bounds, wh, wh))
    for name, scene in KERNEL_SCENES.items():
        flat, bounds, attr, img_h, img_w = (t.to(dev) if torch.is_tensor(t) else t
                                            for t in scene())
        errs.append(compare_kernel(name, flat, bounds, attr, img_h, img_w))
        faceid_errs.append(compare_faceid(name, flat, bounds, img_h, img_w))
    max_abs_err = max(errs)

    # 4a. The evaluation slice: the evaluation CLI at full width.
    n, batch = 64, 32
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "straps_model_checkpoint.tar")
    write_t_pose_checkpoint(ckpt, assets)
    data = os.path.join(tmp.name, "eval.npz")
    write_eval_npz(data, n, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final = run_eval.main(["--dataset", data, "--checkpoint", ckpt, "--img-wh", "256",
                           "--batch-size", str(batch), "--device", "cuda"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = CR.packed_raster_kernel.launches
    n_batches = n // batch
    print(f"slice: eval of {n} samples at 256x256, batch {batch}, bf16 encoder: "
          f"{eval_s:.3f} s wall ({n / eval_s:.2f} samples/s), kernel launches "
          f"{launches} (GT renders {n_batches} + predicted renders {n_batches})")
    if not all(np.isfinite(v) for v in final.values()):
        raise AssertionError(f"non-finite metrics: {final}")
    if not 0.2 < final["silhouette_ious"] <= 1.0:
        raise AssertionError(f"IoU not in (0.2, 1]: {final['silhouette_ious']}")
    if launches < 2 * n_batches:
        raise AssertionError(f"renders bypassed the kernel: {launches} launches")

    # The same evaluation, small and float32, on the card and on the CPU.
    rng = np.random.RandomState(1)
    small = {"poses": (rng.randn(8, 72) * 0.2).astype(np.float32),
             "shapes": (rng.randn(8, 10) * 0.5).astype(np.float32)}
    cfg = PredictConfig(img_wh=64, checkpoint=ckpt)
    cfg.model.compute_dtype = None
    on_card = run_evaluation(small, cfg, batch_size=4, device="cuda")
    on_cpu = run_evaluation(small, cfg, batch_size=4, device="cpu")
    worst = max(abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-9)
                for k in on_cpu if k != "silhouette_ious")
    d_iou = abs(on_card["silhouette_ious"] - on_cpu["silhouette_ious"])
    print(f"reference check, 8 samples 64x64 f32, card vs CPU: worst relative "
          f"metric difference {worst:.3e} (bound 1e-3), IoU difference {d_iou:.3e} "
          f"(bound 2e-3), IoU {on_cpu['silhouette_ious']:.4f}")
    if worst > 1e-3 or d_iou > 2e-3 or not on_cpu["silhouette_ious"] > 0.2:
        raise AssertionError(f"card {on_card} vs CPU {on_cpu}")

    # 4b. The predict slice: the predict CLI over 64 cached proxies at full
    # width, renders included.
    rng = np.random.RandomState(2)
    sils, joints = synthesise_proxy_inputs((rng.randn(n, 72) * 0.2).astype(np.float32),
                                           (rng.randn(n, 10) * 0.5).astype(np.float32),
                                           assets, 512)
    names = [f"img{i:03d}" for i in range(n)]
    # A T-pose head whose last layer still reads the features, so that
    # each image gets its own body.
    ckpt_pred = os.path.join(tmp.name, "straps_model_checkpoint_pred.tar")
    write_t_pose_checkpoint(ckpt_pred, assets, fc3_weight_scale=0.1)
    proxy_dir = os.path.join(tmp.name, "proxies")
    save_proxies(proxy_dir, names, sils, joints)
    out_dir = os.path.join(tmp.name, "predict_256")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        pred = run_predict.main(["--input", proxy_dir, "--checkpoint", ckpt_pred,
                                 "--out-dir", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    print("\n".join(cli_out.getvalue().splitlines()[:3]))
    faceid_launches = CR.faceid_raster_kernel.launches
    print(f"slice: predict of {n} cached proxies at 256x256, bf16 encoder, renders "
          f"included: {predict_s:.3f} s wall ({n / predict_s:.2f} images/s), face-id "
          f"kernel launches {faceid_launches} (rend 1 + reposed 1), packed kernel "
          f"launches {CR.packed_raster_kernel.launches}")
    for name in names:
        for key in ("verts", "shape", "pose_rotmats", "cam_wp"):
            if not np.isfinite(np.load(os.path.join(out_dir, f"{name}_{key}.npy"))).all():
                raise AssertionError(f"non-finite {name}_{key}.npy")
    fg_min = 1.0
    for name in names:
        for kind in ("rend", "reposed"):
            img = decode_png(os.path.join(out_dir, "rend_vis", f"{kind}_{name}.png"))
            if img.shape != (256, 256, 3):
                raise AssertionError(f"{kind}_{name}.png: shape {img.shape}")
            fg_min = min(fg_min, float((img != 255).any(axis=-1).mean()))
        decode_png(os.path.join(out_dir, "proxy_vis", f"{name}.png"))
    print(f"slice: least foreground share of a render {fg_min:.4f}")
    if fg_min <= 0.0:
        raise AssertionError("a render is empty")
    if faceid_launches != 2:
        raise AssertionError(f"predict renders: {faceid_launches} face-id kernel launches, want 2")

    # The face-id kernel against its plain version on the inputs of the two
    # launches the predict just made: all rend bodies, all reposed bodies.
    rend_in = vis_faceid_inputs(assets, pred["verts"], pred["cam_wp"], 256)
    faceid_errs.append(compare_faceid(f"predict rend B={n} 256x256", *rend_in, 256, 256))
    reposed_in = vis_faceid_inputs(assets, pred["reposed_verts"],
                                   torch.tensor(REPOSED_CAM_WP).expand(n, 3), 256,
                                   rotate_x180=True)
    faceid_errs.append(compare_faceid(f"predict reposed B={n} 256x256", *reposed_in,
                                      256, 256))

    # The same predict, small and float32, on the card and on the CPU.
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = os.path.join(tmp.name, f"predict_64_{device}")
        with contextlib.redirect_stdout(io.StringIO()):
            run_predict.main(["--input", proxy_dir, "--checkpoint", ckpt_pred, "--out-dir",
                              outs[device], "--device", device, "img_wh=64",
                              "model.compute_dtype=None"])
    def npy(device, name, key):
        return np.load(os.path.join(outs[device], f"{name}_{key}.npy"))

    worst_npy = max(
        np.abs(npy("cuda", name, key) - npy("cpu", name, key)).max()
        / max(np.abs(npy("cpu", name, key)).max(), 1e-6)
        for name in names for key in ("verts", "shape", "pose_rotmats", "cam_wp"))
    moved = max(
        float((decode_png(os.path.join(outs["cuda"], "rend_vis", f"{kind}_{name}.png"))
               != decode_png(os.path.join(outs["cpu"], "rend_vis", f"{kind}_{name}.png"))
               ).any(axis=-1).mean())
        for name in names for kind in ("rend", "reposed"))
    print(f"reference check, predict of {n} images 64x64 f32, card vs CPU: worst relative "
          f"npy difference {worst_npy:.3e} (bound 1e-4), largest share of render pixels "
          f"that differ {moved:.4f} (bound 0.002)")
    if worst_npy > 1e-4 or moved >= 0.002:
        raise AssertionError("predict on the card disagrees with the CPU")

    # 5. Times.
    flat, bounds, attr = smpl_kernel_inputs(assets, 256, 64, seed=5)
    kernel_ms = cuda_ms(lambda: CR.packed_raster_kernel(flat, bounds, attr, 256, 256), 200)
    plain_ms = cuda_ms(lambda: CR.rasterize_packed_reference(flat, bounds, attr, 256, 256), 3)
    bound_ms, bound_by = kernel_bound_ms(flat, bounds, 256, 256, attr.numel() * 4, 4)
    print(f"times on {card}: packed raster kernel B=64 256x256 culled "
          f"{kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}, "
          f"{100 * bound_ms / kernel_ms:.1f}% of it); plain version {plain_ms:.3f} ms")

    flat, bounds = rend_in
    faceid_ms = cuda_ms(lambda: CR.faceid_raster_kernel(flat, bounds, 256, 256), 200)
    faceid_plain_ms = cuda_ms(lambda: CR.rasterize_faceid_reference(flat, bounds, 256, 256), 3)
    faceid_bound_ms, faceid_bound_by = kernel_bound_ms(flat, bounds, 256, 256, 0, 8)
    print(f"times on {card}: face-id raster kernel B=64 256x256 unculled (predict rend "
          f"bodies) {faceid_ms:.4f} ms (bound {faceid_bound_ms:.4f} ms by {faceid_bound_by}, "
          f"{100 * faceid_bound_ms / faceid_ms:.1f}% of it); plain version "
          f"{faceid_plain_ms:.3f} ms")

    infer_batch = 256
    model, _ = load_regressor_variables(PredictConfig(), assets, device=dev)
    predict = make_predict_fn(model, assets, 256)
    g = torch.Generator().manual_seed(0)
    proxy = (torch.rand(infer_batch, 256, 256, 18, generator=g) < 0.02).float().to(dev)
    step_ms = cuda_ms(lambda: predict(proxy), 10)
    print(f"times on {card}: proxy -> SMPL at batch {infer_batch}, bf16 encoder: "
          f"{step_ms:.3f} ms/batch, {infer_batch / step_ms * 1e3:.1f} inferences/s")
    rng = np.random.RandomState(0)
    eval_data = {"poses": (rng.randn(n, 72) * 0.2).astype(np.float32),
                 "shapes": (rng.randn(n, 10) * 0.5).astype(np.float32)}
    profile_run(card, f"eval of {n} samples at 256x256, batch {batch}", n, "samples",
                lambda: run_evaluation(eval_data, PredictConfig(checkpoint=ckpt),
                                       batch_size=batch, device="cuda"))
    predict_cfg = PredictConfig(input_dir=proxy_dir, checkpoint=ckpt_pred, out_dir=out_dir)
    profile_run(card, f"predict of {n} cached proxies at 256x256, renders included", n,
                "images", lambda: predict_3d(predict_cfg, device="cuda"))
    tmp.cleanup()

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "raster_packed", "route": "cuda",
        "source": "straps_tpu_torch/csrc/raster_packed.cu",
        "replaces": "straps_tpu/render/pallas_raster.py:106",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "raster_faceid", "route": "cuda",
        "source": "straps_tpu_torch/csrc/raster_faceid.cu",
        "replaces": "straps_tpu/render/pallas_raster.py:50",
        "launches": faceid_launches, "max_abs_err": max(faceid_errs), "ms": faceid_ms,
        "plain_ms": faceid_plain_ms, "bound_ms": faceid_bound_ms,
        "bound_by": faceid_bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
