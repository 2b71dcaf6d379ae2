#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`straps_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles both rasteriser kernels from `straps_tpu_torch/csrc`
     (each `.cu` with the shared `raster_span.cuh`) and the training-mode
     BatchNorm kernels (`batchnorm.cu`), one nvcc each, and
     the host C++ there (the JPEG decoder, the PNG unfilter, the npy
     reader, the zstd decoder) with g++, all started together;
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, bit for bit (packed keys; face ids and depths): two triangles;
     the synthetic SMPL mesh at 256x256, B=8 and B=32, culled and not, a
     ragged 250x250 and a 512x512 of two 256-column tiles; the scenes of
     `tests/raster_scenes.py` (wide triangles across tile edges, ragged
     widths, near-horizontal edges, vertices on pixel centres, special
     planes, a coplanar depth tie across two chunks); then the BatchNorm
     kernels at ResNet-50's 53 training shapes at B=140, 256x256, bfloat16
     (`batchnorm_kernel_entry`): y and dx bit for bit against their plain
     version given the kernels' statistics, the Function against the plain
     formula under autograd within one bfloat16 ulp, and their ms a step
     (the `kernels` line's third entry);
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
     - the training CLI (`run_train --synthetic-data`) for one epoch at
       the released configuration (batch 140, 256x256, ResNet-18 + IEF,
       bfloat16 encoder, every augmentation on): 4 train and 2 validation
       steps, so exactly 6 packed-kernel launches; losses and metrics
       finite, the checkpoint written and read back with
       `weights_only=True`, the loss log-variances moved; the packed kernel
       held against its plain version, bit for bit, on the inputs of the
       CLI's first train launch (its corpus batch and draws: B=140,
       jittered cameras, vertex noise, back faces culled); then one train
       step at 64x64, B=8, float32 on the card and on the CPU from the same
       state and draws, which must agree (loss, gradients, BatchNorm
       running statistics);
     - the predict CLI from 16 PNG images (`--silh-from pointrend`; 8 at
       640x480 and 8 at 1024x768, lit synthetic bodies over seeded noise,
       written by the port's PNG writer) through Keypoint-RCNN and
       PointRend R50-FPN at full width (512 frame, 800x800 detectors, 512
       proposals, 8 detections, 5 subdivision steps; detectron2 pickles of
       the port's seeded init with the person logit raised), the regressor
       at 256x256: every image has detections, npy outputs finite, exactly
       2 face-id launches, the face-id kernel bit for bit on the inputs of
       those two launches; a rerun over the proxies the run cached gives
       identical npy outputs; both detectors on the card and on the CPU on
       2 of the images at 256x256, float32 (the CPU run's NMS decisions
       clear of their thresholds; FPN features and RPN outputs within 1e-4
       of each tensor's largest value, boxes 0.1 px, keypoints 0.1 px,
       masks 99% of pixels), and the Keypoint-RCNN trunk's stages between
       the RPN outputs and the boxes (proposals, pooled box features,
       cls_score and bbox_pred, decoded boxes) on each device's own chain
       and with the card fed the CPU's inputs of each stage;
     - the predict CLI from the same 16 PNGs with `--silh-from densepose`:
       Keypoint-RCNN R50-FPN and DensePose-RCNN R101-FPN at full width
       (800x800, 512 proposals, 8 detections, the DensePose head at 14x14
       x 512 and S/I/U/V at 56x56; the DensePose pickle's coarse
       segmentation foreground raised too): detections on every image,
       exactly 2 face-id launches held bit for bit, the cached rerun
       identical, the DensePose overlays written; DensePose on the card and
       on the CPU on 2 images at 256x256, float32 (features, RPN outputs
       and S/I/U/V logits as shares of each tensor's largest value, boxes
       in px, part maps on the detections whose integer paste geometry
       agrees, the others counted);
     - the evaluation CLI on an SSP-3D release layout (`labels.npz` and
       silhouette PNGs of 64 synthetic bodies at 512x512) at 256x256,
       batch 32, with `--iou-frame image` (one packed launch per batch,
       IoU above 0.2) and `--iou-frame crop`;
     - the training CLI at ResNet-50 with the silhouette task (its soft
       silhouettes at 64x64) and `--profile-dir`, one epoch at the
       released configuration otherwise: exactly 6 packed-kernel launches,
       a finite history, the silhouette log-variance moved, the checkpoint
       read back with `weights_only=True` holding Bottleneck keys, the
       parameter count printed, a trace that shows the 6 packed launches;
       the predict CLI over the 64 cached proxies with `--resnet-layers 50`
       and that checkpoint (exactly 2 face-id launches, finite outputs);
       one ResNet-50 train step with the silhouette task at 64x64, B=8,
       float32 on the card and on the CPU (no IEF gate may differ; the
       encoder's differing gates are counted);
     - data parallelism (`straps_tpu_torch/parallel/`), in spawned ranks:
       a rank in an NCCL group of one runs one float32 train step at
       64x64, B=8 through the mesh path, held against the single-process
       step to phase 4c's bounds (no IEF gate may differ), and the
       evaluation at 256x256, batch 32 over the mesh, equal to the plain
       run bit for bit; two gloo ranks on cuda:0 run the same step over a
       mesh of two, held against the NCCL step, with one packed launch a
       rank and bitwise-identical replicas after it; `run_train
       data_parallel_devices=<cards + 1>` exits non-zero with its message
       before writing a file;
     - JPEG photos and the whole vis output: the fixtures of
       `tests/torch_jpeg/` decoded and held to the SHA-256 of cv2.imread's
       pixels committed beside them; the predict CLI over phase 4d's 16
       PNGs and those 6 JPEGs through PointRend at full width (every image
       with detections, finite outputs, exactly 2 face-id launches held bit
       for bit, the cached rerun identical, a 640x480 `verts_vis` figure
       and red joint-index text for every image), `verts_over_image_vis`
       of two of its images on the card and on the CPU (no pixel may
       differ, and the predict's file equals the card's figure); the
       predict CLI over phase 4b's 64 cached proxies read by the native
       reader (its batch equal to numpy's, exactly 2 face-id launches, 64
       400x400 3D scatters);
     - the real-asset parity gate (`cli/run_parity_gate.py`) over stand-ins
       written in the real formats (a reference `additional/` directory
       from the synthetic fixture with numpy, scipy and pickle: the SMPL
       pkl with a scipy-sparse `J_regressor`, the regressor npys, the
       mean-params npz, the colour-cube parts; phase 4b's reference
       `.tar`; phase 4d's three detectron2 pickles): `python -m` with every
       flag over the 64 cached proxies at 256x256 (exit 0, every row PASS,
       the SMPL forward on the card within 1e-4 m of the float64 numpy
       oracle, printed); the gate through PointRend over the 16 PNGs at
       full width (exit 0); against the first run's outputs as
       `--expected` (PASS), then with those vertices moved by 5 mm (the
       gate's own FAIL, exit 1); a Keypoint-RCNN pickle short of one
       backbone tensor (FAIL by name, exit 1).  The phase's wall time is
       printed and held to 60 s; the gate predicts with `save_vis=False`,
       so neither kernel is launched in it;
     - the detector training side at R101-FPN width, float32: the
       DensePose-RCNN trunk at 800x800 on 2 of phase 4d's images, 128
       training ROIs (64 an image, seeded jitters of synthetic people, some
       above and some below IoU 0.7) with `DensePoseDataRelative`
       annotations (14 RLE part masks, 64-128 points, every other one
       flipped) through `densepose_data_filter`, the legacy 14x14 pooler,
       the DeepLab head (512 wide, 8 GroupNorm convs, ASPP (6, 12, 56),
       NonLocal), the predictor to 56x56, `densepose_losses` and the
       backward, on the card and on the CPU from the card's pooled
       features (head output within 1e-4 of its largest, each loss 1e-5
       relative, each gradient 1e-3 of its largest), its times in float32
       and under bfloat16 autocast and its peak memory; PointRend's coarse
       head on the same ROIs, 196 importance points drawn on the card, the
       point head, `mask_point_loss` against 28x28 masks and the backward,
       the CPU given the card's draws (the chosen points equal wherever the
       top-k cut clears 1e-5, the loss 1e-5 relative, the gradients 1e-4);
       a DeepLab pickle written by `save_d2_pkl` loaded with `strict=True`
       and a flax DeepLab tree written from numpy through
       `flax_detector_to_torch_state_dict`, both equal to the seeded head.
       The phase's wall time is held to 40 s, and it launches neither
       kernel;
     - the JAX package's orbax checkpoints, without JAX, orbax or
       tensorstore: the committed JAX-written fixture
       (`tests/torch_orbax/`) restored and held to its SHA-256 digests,
       the zstd modes its frames reached printed (each of orbax's level-1
       modes met); the training slice's trained ResNet-18 written with
       `save_orbax_checkpoint` (~191 MB) and read back bit for bit; on
       that directory against the same on the `.pt`: the predict CLI over
       the 64 cached proxies at 256x256 (npy outputs bit-identical, exactly
       2 face-id launches), the evaluation CLI on the 64 synthetic samples
       (metrics equal, exactly 4 packed launches), the parity gate (exit 0,
       every row PASS), and the training CLI resumed from it for one epoch
       (history and state equal, exactly 6 packed launches); then the
       restore's seconds and MB/s, the decoder's MB/s on the fixture's
       frames, the write's seconds, and the restore of a directory as
       large whose chunks are the fixture's compressed frames;
     - every PNG and JPEG form cv2.imread reads: the committed fixtures
       (`tests/torch_png/`, `tests/torch_jpeg/`) decoded and held to
       cv2.imread's SHA-256 (PNGs in both reads; the JPEG codings cv2
       reads no image from refused), each decoder's host milliseconds per
       fixture, a 1024x768 interlaced palette PNG and the 600x452
       arithmetic-coded progressive JPEG timed; the predict CLI through
       PointRend at full width over 4 of the image slice's bodies rewritten
       as palette, 16-bit, 1-bit and interlaced PNGs, the arithmetic,
       lossless and cut JPEG fixtures, a progressive JPEG cut at run time
       and an arithmetic JPEG named `.png` (detections on every image,
       finite outputs, exactly 2 face-id launches held bit for bit, the
       cached rerun identical); the release-layout eval on the same layout
       with its silhouettes as palette, coloured and 16-bit PNGs, every
       metric equal to the 8-bit grey layout's (2 packed launches each);
       and one train epoch on the synthetic body model of seed 3
       (generated, not read; exactly 6 packed launches);
     - every other orbax layout: the committed layout fixtures
       (`tests/torch_orbax/layouts/`, written by orbax: zarr v2 and zarr3,
       with and without OCDBT, a bfloat16 state, every dtype, scalars,
       strings) held to their digests; the orbax slice's directory
       rewritten by `tests/torch_orbax/relayout.py` as zarr v2 without
       OCDBT, zarr3 with and without it, and zarr3 with its parameters,
       statistics and moments in bfloat16, each restore timed; on each,
       the predict CLI over the 64 cached proxies (npy outputs equal to
       the `.pt` run's, the bfloat16 one to the `.pt` rounded to bfloat16;
       exactly 2 face-id launches, held bit for bit); the evaluation CLI
       on the zarr3 directory and the training CLI resumed one epoch from
       the per-leaf one, equal to the orbax slice's (4 and 6 packed
       launches); the resume from the bfloat16 one refused by name;
     - the port as `pip install .` installs it: the files that
       `pyproject.toml` selects (`utils/package_copy.py`) copied outside
       the repository, and a fresh process whose only copy of the port is
       that one (its working directory outside the repository too):
       every subpackage imported and every name of every `__all__` and
       `JAX_COUNTERPARTS` resolved; both rasterisers, the BatchNorm
       kernels and the host C++ built from the copy's own `csrc/` into
       the copy's `_build/` (each build
       timed); the evaluation CLI over the evaluation slice's 64 samples
       and the predict CLI over the predict slice's 64 cached proxies at
       full width, metrics and npy outputs equal to those slices', exactly
       4 packed and 2 face-id launches, each held bit for bit against its
       plain version (both entries' `installed_launches`);
  5. times: each kernel at B=64, 256x256 (packed: culled eval bodies;
     face-id: unculled, the predict renders' own bodies), beside its bound
     and its plain version; the evaluation's and the predict's wall time;
     proxy -> SMPL inferences/s at batch 256; a warm train step at batch
     140 on the CLI's first train batch (median of 12 after 3 warm-up
     steps), split into the synthetic batch and the forward/backward/
     update, three steps under the profiler, and the packed kernel on that
     batch's render beside its bound.  The `kernels` line gives the packed
     kernel's B=64 eval-body numbers under `ms`, `plain_ms` and `bound_ms`,
     its first-train-batch numbers under `train_*`, and its launches on
     the evaluation and training paths; `inputs` names the bodies; the
     face-id entry's `image_path_launches` and `densepose_path_launches`
     are the two image predicts', the packed entry's
     `release_eval_launches` the release-layout eval's.  The image slice:
     each detector's forward on a chunk of 8 at 800x800 in float32 and
     with the bfloat16 backbone, its peak memory and NMS's share (for
     DensePose its stages: backbone + FPN, RPN + box head, DensePose
     pooler + head + predictor, the paste), the warm image predicts under
     the profiler, and the warm release-layout eval under the profiler.
     The ResNet-50 + silhouette train step at batch 140 (median of 12
     after 3 warm-up steps, peak memory, three steps under the profiler)
     and the soft silhouette's forward and backward at batch 140, 64x64.
     The packed entry's `r50_silhouette_train_launches` and the face-id
     entry's `r50_predict_launches` count phase 4g's launches, which both
     entries' `launches` include; the packed entry's `ddp_launches` count
     phase 4h's ranks' launches, which its `launches` include.  The warm
     released-configuration train step in an NCCL rank of one, through
     the plain path and the mesh path in turns, with the collectives and
     bytes of a mesh step.  Phase 4i's work, medians of 5: `decode_jpeg`
     of each fixture (host), the 128 cached npy files through the native
     reader and through a numpy loop, `verts_over_image_vis` and
     `scatter_vis` per image (figure alone, and with its PNG write), and
     the warm mixed-format predict; the face-id entry's
     `jpeg_path_launches` and `native_cached_launches` count phase 4i's
     launches, which its `launches` include; both entries'
     `orbax_launches` count phase 4l's launches on the orbax directory,
     which their `launches` include, and `installed_launches` phase 4o's.
The whole run's wall time, then the card's name and power limit come
before the `kernels` JSON, which is on the line before the last; the result
JSON is last.
Exits non-zero without a card, and outside a checkout of the repository.
"""

import contextlib
import copy
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

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


def batchnorm_kernel_entry(card, batch=140, depth=50):
    """The training-mode BatchNorm kernels (`csrc/batchnorm.cu`) at the
    shapes of ResNet-50's 53 layers at 18 x 256², B=140, bfloat16
    channels-last: each kernel held to its plain version (y and dx bit for
    bit given the kernels' statistics), the Function under autograd and the
    plain training formula to the same formula in float64 (one bfloat16
    ulp, plus what the statistics' summation order may move:
    `tests/torch_bn.py::within_bound`; the kernels must pass, the plain
    formula's reading is printed beside), then ms a training step: each
    kernel and all four (CUDA events, summed over the layers), the plain
    formula's forward and backward, PyTorch's `batch_norm` in training mode
    forward and backward (`library_ms`: timed only, since its variance
    arithmetic is not flax's), and the least time (10 bytes an element: x
    read and y written, dy and x read and dx written, over 3.35 TB/s).
    Returns the `kernels` line's entry; raises on a mismatch."""
    from straps_tpu_torch.models import batchnorm as BN
    from torch_bn import bn_input_shapes, channel_bounds, float64_truth, within_bound

    K = BN.batchnorm_kernels
    shapes = bn_input_shapes(depth, batch)
    dev = torch.device("cuda")
    cl = torch.channels_last
    ms = {"stats": 0.0, "normalize": 0.0, "backward_sums": 0.0, "backward_dx": 0.0}
    plain_ms, library_ms, worst, worst_plain, worst_abs, elements = 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for shape in sorted(set(shapes)):
        layers = shapes.count(shape)
        n, c, h, w = shape
        elements += layers * n * c * h * w
        g = torch.Generator().manual_seed(c + h)
        x = (torch.randn(shape, generator=g) * 2 + 0.5)
        x[:, c // 2] = 0.7
        x = x.to(dev, torch.bfloat16, memory_format=cl)
        dy = torch.randn(shape, generator=g).to(dev, torch.bfloat16, memory_format=cl)
        norm = BN.BatchNorm2d(c).to(dev).train()
        with torch.no_grad():
            norm.weight.copy_(torch.rand(c, generator=g) + 0.5)
            norm.bias.copy_(torch.randn(c, generator=g))
        rm, rv = norm.running_mean.clone(), norm.running_var.clone()
        tracked = norm.num_batches_tracked.clone()
        count = x.numel() // c
        sums = K.stats(x)
        y, st = K.normalize(x, sums, norm.weight, norm.bias, rm, rv, tracked, count, 1e-5, 0.1)
        bsums, _, _ = K.backward_sums(dy, x, st)
        dx = K.backward_dx(dy, x, st, bsums, count)
        if not (torch.equal(y, BN.batchnorm_normalize_reference(x, st, norm.bias))
                and torch.equal(dx, BN.batchnorm_backward_dx_reference(dy, x, st, bsums,
                                                                        count))):
            raise AssertionError(f"BatchNorm kernels differ from their plain version at {shape}")
        runs = []
        for plain in (False, True):
            m = copy.deepcopy(norm)
            xr = x.clone().requires_grad_(True)
            yr = m.plain_train_forward(xr) if plain else m(xr)
            yr.backward(dy)
            runs.append((yr.detach().float(), xr.grad.float()))
        rel_c, abs_c = channel_bounds(x, norm.weight)
        truth = float64_truth(x, norm.weight, norm.bias, dy)
        for (a, b, t), factor in zip(zip(*runs, truth), (1.0, 3.0)):
            worst = max(worst, within_bound(a, t, torch.bfloat16, rel_c, abs_c, factor))
            worst_plain = max(worst_plain,
                              within_bound(b, t, torch.bfloat16, rel_c, abs_c, factor))
            worst_abs = max(worst_abs, float((a - b).abs().max()))
        del truth
        ms["stats"] += layers * cuda_ms(lambda: K.stats(x), 20)
        ms["normalize"] += layers * cuda_ms(lambda: K.normalize(
            x, sums, norm.weight, norm.bias, rm, rv, tracked, count, 1e-5, 0.1), 20)
        ms["backward_sums"] += layers * cuda_ms(lambda: K.backward_sums(dy, x, st), 20)
        ms["backward_dx"] += layers * cuda_ms(lambda: K.backward_dx(dy, x, st, bsums, count), 20)

        def plain_step():
            xr = x.clone().requires_grad_(True)
            norm.plain_train_forward(xr).backward(dy)
        plain_ms += layers * cuda_ms(plain_step, 5)

        def library_step():
            xr = x.clone().requires_grad_(True)
            torch.nn.functional.batch_norm(xr, None, None, norm.weight, norm.bias,
                                           training=True, eps=1e-5).backward(dy)
        library_ms += layers * cuda_ms(library_step, 5)
        del x, dy, y, dx, xr, yr, runs
    if worst > 1.0:
        raise AssertionError(f"BatchNorm Function vs the float64 formula: {worst:.3f} of the "
                             f"bound (the plain float32 formula: {worst_plain:.3f})")
    total = sum(ms.values())
    bound_ms = 10 * elements / H100_HBM_BYTES_S * 1e3
    print(f"times on {card}: BatchNorm kernels over ResNet-50's {len(shapes)} layers at B={batch}, "
          f"256x256, bfloat16 channels-last ({elements} elements): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; all four {total:.4f} ms a step against a least {bound_ms:.4f} ms by bytes "
          f"({100 * bound_ms / total:.1f}% of it); plain formula forward + backward "
          f"{plain_ms:.3f} ms; PyTorch's own batch_norm (training, not on the path) forward + "
          f"backward {library_ms:.3f} ms; y and dx against the float64 formula: {worst:.3f} of the bound "
          f"(the plain float32 formula {worst_plain:.3f}); largest gap to the plain formula "
          f"{worst_abs:.4g}")
    return {"name": "batchnorm", "route": "cuda", "source": "straps_tpu_torch/csrc/batchnorm.cu",
            "replaces": None,
            "inputs": f"ResNet-50's {len(shapes)} BatchNorm layers at B={batch}, 18 x 256x256, "
                      f"bfloat16 channels-last: ms, plain_ms, library_ms and bound_ms a training "
                      f"step (the four kernels; the plain formula's forward and backward; "
                      f"torch.nn.functional.batch_norm's forward and backward; 10 bytes an "
                      f"element over 3.35 TB/s); kernel_ms each kernel; r18_train_launches and "
                      f"r50_train_launches: the train CLI's epochs of phases 4c and 4g (4 "
                      f"launches a layer a train step; validation runs eval mode); launches: "
                      f"their sum",
            "launches": None, "max_abs_err": worst_abs, "err_of_bound": worst,
            "plain_err_of_bound": worst_plain, "ms": total,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "kernel_ms": ms, "elements": elements}


def check_batchnorm_launches(label, launches, depth, train_steps):
    """Raise unless `launches` is the BatchNorm kernels' four launches a
    layer of the ResNet encoder at `depth` in each of `train_steps` train
    steps: the training path runs them on every layer."""
    from torch_bn import bn_input_shapes
    layers = len(bn_input_shapes(depth, 1))
    want = 4 * layers * train_steps
    if launches != want:
        raise AssertionError(f"{label}: {launches} BatchNorm kernel launches, want 4 x "
                             f"{layers} layers x {train_steps} train steps = {want}")


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


def first_train_batch(cfg, corpus_path, device):
    """The pose and shape batch of the first train step of epoch 0 as
    `train()` draws it from the corpus at `corpus_path`, and that step's
    draws' generator."""
    from straps_tpu_torch.data.dataset import SyntheticTrainingDataset, epoch_batches

    ds = SyntheticTrainingDataset(corpus_path, cfg.params_from)
    b = next(epoch_batches(ds, cfg.batch_size, np.random.RandomState(cfg.seed)))
    generator = torch.Generator(device=device).manual_seed(cfg.seed * 100003)
    return (torch.as_tensor(b["pose"], device=device),
            torch.as_tensor(b["shape"], device=device), generator)


def training_kernel_inputs(assets, cfg, corpus_path):
    """The packed kernel's inputs (flat planes, int32 bounds, attributes)
    of the first train step of epoch 0 on the corpus at `corpus_path`: the
    arguments `generate_synthetic_batch` hands the rasteriser on that
    step's bodies and draws, recorded on their way in."""
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.render import renderer
    from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch

    dev = assets.device
    pose, shape, generator = first_train_batch(cfg, corpus_path, dev)
    draws = draw_synthetic(generator, cfg.batch_size, assets.num_verts, cfg, dev)
    seen = []
    real = renderer.rasterize_packed

    def record(planes, bounds, face_attr, img_h, img_w):
        seen.append((planes, bounds, face_attr))
        return real(planes, bounds, face_attr, img_h, img_w)
    renderer.rasterize_packed = record
    try:
        generate_synthetic_batch(draws, pose, shape, assets, cfg)
    finally:
        renderer.rasterize_packed = real
    (planes, bounds, face_attr), = seen
    flat, attr = CR.pack_planes(planes, face_attr)
    return flat, bounds.to(torch.int32).contiguous(), attr


def draws_to(draws, device):
    """A `SyntheticDraws` with every tensor moved to `device`."""
    return type(draws)(*(draws_to(d, device) if isinstance(d, tuple) else d.to(device)
                         for d in draws))


def synced_ms(fn, warm: int, reps: int):
    """Host-clock ms of each of `reps` calls of `fn()`, each fenced by CUDA
    synchronisations, after `warm` unmeasured calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# The silhouette task on (phases 4g, 5): the released tasks and weights
# plus 'silhouette' at weight 1.
SIL_TASKS = ("verts", "shape_params", "pose_params", "joints2D", "joints3D", "silhouette")
SIL_WEIGHTS = {"verts": 1.0, "joints2D": 0.1, "pose_params": 0.1, "shape_params": 0.1,
               "joints3D": 1.0, "silhouette": 1.0}


def train_step_on(device, seed=5, resnet_layers=18, silhouette=False, replay=None):
    """One train step at 64x64, B=8, float32 encoder on `device` from the
    seeded state and draws (the draws made on the CPU): the loss, the task
    losses, every parameter's gradient, the BatchNorm running statistics
    after the step and the IEF's fc1/fc2 pre-activations (the ReLU gates),
    on the CPU, the encoder's selections (`tests/torch_gates.py`) and the
    state's digest.  With `replay`, the encoder takes those selections of
    another run.  In a process group (phase 4h) the step runs over the
    data mesh: this rank's rows of the batch and draws, global loss and
    gradients, this rank's gates."""
    from straps_tpu_torch.config import TrainConfig
    from straps_tpu_torch.parallel import shard_batch
    from straps_tpu_torch.train.loop import build_training
    from straps_tpu_torch.train.synthetic import draw_synthetic, shard_draws
    from torch_gates import record_encoder_gates, replay_encoder_gates

    cfg = TrainConfig(img_wh=64, batch_size=8, focal_length=1250.0)
    cfg.model.compute_dtype = None
    cfg.model.resnet_layers = resnet_layers
    if silhouette:
        cfg.losses_on, cfg.init_loss_weights = SIL_TASKS, dict(SIL_WEIGHTS)
    rng = np.random.RandomState(seed)
    pose = torch.tensor((rng.randn(8, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(8, 10) * 0.5).astype(np.float32))
    _, assets, state, train_step, _ = build_training(cfg, device=device)
    gates = []
    for fc in (state.model.ief_module.fc1, state.model.ief_module.fc2):
        fc.register_forward_hook(lambda m, i, o: gates.append(o.detach().cpu().flatten()))
    encoder = state.model.image_encoder
    if replay is not None:
        replay_encoder_gates(encoder, replay)
        enc_gates = None
    else:
        enc_gates = record_encoder_gates(encoder)
    draws = draw_synthetic(torch.Generator().manual_seed(seed), 8, assets.num_verts, cfg, "cpu")
    if state.mesh is not None:
        draws = shard_draws(draws, state.mesh)
        pose, shape = shard_batch((pose, shape), state.mesh)
    loss, tasks, _ = train_step(state, draws_to(draws, device), pose.to(device),
                                shape.to(device))
    return (float(loss), {k: float(v) for k, v in tasks.items()},
            {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            {k: b.detach().cpu() for k, b in state.model.named_buffers() if "running" in k},
            torch.cat(gates), enc_gates, state.digest())


def check_train_step_card_vs_cpu(label, **kw):
    """One train step (`train_step_on`) on the card and on the CPU, held to
    its bounds: no IEF ReLU gate differs; loss and task losses 1e-4
    relative, BatchNorm running statistics 1e-4 of each tensor's largest;
    gradients 2e-3 of each tensor's largest.  The encoder's selections
    that differ are counted; where some do, the gradients are held against
    a CPU step that replays the card's selections (and the free CPU step's
    gradient difference is reported)."""
    from torch_gates import count_flips

    loss_k, tasks_k, grads_k, stats_k, gates_k, enc_k, _ = train_step_on("cuda", **kw)
    loss_c, tasks_c, grads_c, stats_c, gates_c, enc_c, _ = train_step_on("cpu", **kw)
    flipped = int(((gates_k > 0) != (gates_c > 0)).sum())
    enc_flips = count_flips(enc_k, enc_c)
    print(f"reference check, {label}: IEF ReLU gates that differ between card and CPU "
          f"{flipped} of {gates_c.numel()} (smallest |pre-activation| "
          f"{float(gates_c.abs().min()):.3e}, largest card-vs-CPU difference "
          f"{float((gates_k - gates_c).abs().max()):.3e}); encoder ReLU gates and max-pool "
          f"selections that differ {enc_flips} of {sum(g.numel() for g in enc_c)}")
    if flipped:
        raise AssertionError(f"{label}: an IEF ReLU gate differs between card and CPU")

    def worst_grad(grads):
        return max((float((grads_k[k] - g).abs().max() / g.abs().max()), k)
                   for k, g in grads.items())
    d_free, worst_free = worst_grad(grads_c)
    if enc_flips:
        grads_r = train_step_on("cpu", replay=enc_k, **kw)[2]
        d_grad, worst = worst_grad(grads_r)
        replayed = (f"; against the CPU step replaying the card's encoder selections "
                    f"{d_grad:.3e} ({worst})")
    else:
        d_grad, replayed = d_free, ""
    d_loss = max([abs(loss_k - loss_c) / abs(loss_c)]
                 + [abs(tasks_k[t] - tasks_c[t]) / abs(tasks_c[t]) for t in tasks_c])
    d_stats = max(float((stats_k[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                  for k, v in stats_c.items())
    print(f"reference check, {label}, card vs CPU: loss and task losses worst relative "
          f"difference {d_loss:.3e} (bound 1e-4), BatchNorm running statistics worst "
          f"{d_stats:.3e} of a tensor's largest (bound 1e-4), gradients worst {d_free:.3e} of "
          f"a tensor's largest ({worst_free}){replayed} (bound 2e-3); loss {loss_c:.6f}, "
          f"task losses " + ", ".join(f"{k} {v:.6f}" for k, v in tasks_c.items()))
    if d_loss > 1e-4 or d_grad > 2e-3 or d_stats > 1e-4:
        raise AssertionError(f"{label}: the train step on the card disagrees with the CPU")


def check_mesh_step(label, got, want, gates=True):
    """A train step over a data mesh (`train_step_on`'s outputs in a group)
    held against another to phase 4c's card-vs-CPU bounds: loss and task
    losses 1e-5 relative, gradients 2e-3 and BatchNorm running statistics
    1e-4 of each tensor's largest, and, with `gates`, no IEF ReLU gate
    differing."""
    loss_g, tasks_g, grads_g, stats_g, gates_g = got[:5]
    loss_w, tasks_w, grads_w, stats_w, gates_w = want[:5]
    d_loss = max([abs(loss_g - loss_w) / abs(loss_w)]
                 + [abs(tasks_g[t] - v) / abs(v) for t, v in tasks_w.items()])
    d_grad, worst = max((float((grads_g[k] - g).abs().max() / g.abs().max()), k)
                        for k, g in grads_w.items())
    d_stats = max(float((stats_g[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                  for k, v in stats_w.items())
    flipped = int(((gates_g > 0) != (gates_w > 0)).sum()) if gates else 0
    print(f"reference check, {label}: loss and task losses worst relative difference "
          f"{d_loss:.3e} (bound 1e-5), gradients worst {d_grad:.3e} of a tensor's largest "
          f"({worst}; bound 2e-3), BatchNorm running statistics worst {d_stats:.3e} (bound "
          f"1e-4)" + (f", IEF ReLU gates that differ {flipped} of {gates_w.numel()}"
                      if gates else "") + f"; loss {loss_g:.6f}")
    if d_loss > 1e-5 or d_grad > 2e-3 or d_stats > 1e-4 or flipped:
        raise AssertionError(f"{label}: the mesh step disagrees")


def ddp_nccl_checks(ckpt, eval_data, batch):
    """Phase 4h's NCCL rank (a group of one on the card): one train step at
    64x64, B=8, float32 through the mesh path (a), and the evaluation of
    `eval_data` at 256x256 over the mesh (c); each with its packed-kernel
    launches."""
    from straps_tpu_torch.config import PredictConfig
    from straps_tpu_torch.eval_harness.runner import run_evaluation
    from straps_tpu_torch.parallel import make_mesh
    from straps_tpu_torch.render import cuda_raster as CR
    sys.path.insert(0, os.path.join(HERE, "tests"))

    reset_launches()
    step = train_step_on("cuda")
    step_launches = CR.packed_raster_kernel.launches
    reset_launches()
    final = run_evaluation(eval_data, PredictConfig(checkpoint=ckpt), batch_size=batch,
                           device="cuda", mesh=make_mesh(0, "cuda"))
    return step, step_launches, final, CR.packed_raster_kernel.launches


def ddp_gloo_step():
    """One of phase 4h's two gloo ranks on `cuda:0` (b): `train_step_on`
    over the mesh, with this rank's packed-kernel launches."""
    from straps_tpu_torch.render import cuda_raster as CR
    sys.path.insert(0, os.path.join(HERE, "tests"))

    reset_launches()
    step = train_step_on("cuda:0")
    return step, CR.packed_raster_kernel.launches


def ddp_step_times(corpus):
    """Phase 5's NCCL rank (a group of one): the warm train step at the
    released configuration on the CLI's first train batch, through the
    plain path and through the mesh path in turns (plain, mesh, mesh,
    plain: each the median of 12 after 3 warm-up steps, draws to the host
    pull), the collectives and bytes of one mesh step, and three steps of
    each path under the profiler (printed; their device busy ms
    returned).  Both paths step one model and optimizer: the plain path
    through a view of the state without its mesh."""
    import dataclasses

    from straps_tpu_torch.config import TrainConfig
    from straps_tpu_torch.parallel import shard_batch
    from straps_tpu_torch.train.loop import build_training, pull_to_host
    from straps_tpu_torch.train.synthetic import draw_synthetic, shard_draws

    cfg = TrainConfig()
    _, assets, state, train_step, _ = build_training(cfg, device="cuda")
    mesh, dev = state.mesh, state.mesh.device
    plain = dataclasses.replace(state, mesh=None)
    pose, shape, gen = first_train_batch(cfg, corpus, dev)

    def step_of(on_mesh):
        def run():
            draws = draw_synthetic(gen, cfg.batch_size, assets.num_verts, cfg, dev)
            if on_mesh:
                pull_to_host(*train_step(state, shard_draws(draws, mesh),
                                         *shard_batch((pose, shape), mesh)))
            else:
                pull_to_host(*train_step(plain, draws, pose, shape))
        return run

    times = {"plain": [], "mesh": []}
    for label in ("plain", "mesh", "mesh", "plain"):
        times[label].append(synced_ms(step_of(label == "mesh"), warm=3, reps=12))
    run = step_of(True)
    before = (mesh.collectives, mesh.bytes_reduced)
    run()
    collectives, reduced = mesh.collectives - before[0], mesh.bytes_reduced - before[1]
    busy = {}
    for label in ("plain", "mesh"):
        run = step_of(label == "mesh")
        busy[label] = profile_run(card_line(), f"3 train steps at batch {cfg.batch_size}, "
                                  f"{cfg.img_wh}x{cfg.img_wh}, {label} path in an NCCL rank "
                                  f"of one",
                                  3 * cfg.batch_size, "samples", lambda: [run() for _ in range(3)])
    return times, collectives, reduced, busy


def reset_launches():
    from straps_tpu_torch.utils import native_build
    native_build.reset_launches()


def write_eval_npz(path, n, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, poses=(rng.randn(n, 72) * 0.2).astype(np.float32),
             shapes=(rng.randn(n, 10) * 0.5).astype(np.float32),
             genders=np.asarray(["n"] * n))


def profile_run(card, label, n, unit, run, top=10, host_top=8):
    """Wall time of `run()` twice (the second warm), then one profiled run:
    the device busy share, the entries with the most device time and the
    rasteriser kernels' entries, then the host's kernel launches and the
    host entries with the most self time.  Returns the device busy ms of
    the profiled run (None when the profiler saw no device time)."""
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
        return None
    print(f"profile on {card}: {label} {wall_ms:.2f} ms wall under the profiler, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    # The entries with the most device time, and the rasteriser kernels'
    # wherever they rank.
    for e in events[:top] + [e for e in events[top:] if "span_raster" in e.key]:
        print(f"  {device_us(e) / 1e3:9.3f} ms {100 * device_us(e) / 1e3 / busy_ms:5.1f}%"
              f"  x{e.count:<5d} {e.key[:100]}")
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    launched = sum(e.count for e in host if "LaunchKernel" in e.key)
    print(f"  host: {launched} kernel launches, {len(host)} kinds of host entry; most self time:")
    for e in host[:host_top]:
        ms = e.self_cpu_time_total / 1e3
        print(f"  {ms:9.3f} ms {100 * ms / wall_ms:5.1f}% of wall  x{e.count:<5d} {e.key[:100]}")
    return busy_ms



# The detector slice (phase 4d): a 512 frame, detectron2's 800 test size.
DET_FRAME, DET_TEST = 512, 800
# The host C++ of `straps_tpu_torch/csrc/`, built with g++ beside the kernels.
HOST_SOURCES = ("jpeg_decode", "png_decode", "straps_io", "zstd_decode")
# The port's subpackages with a `JAX_COUNTERPARTS` surface.
SURFACES = ("augment", "data", "eval_harness", "geometry", "losses", "metrics", "models", "ops",
            "parallel", "perception", "predict", "render", "smpl", "train")
DET_SEED = 1
RPN_DELTA_SCALE = 0.1


def write_detector_pngs(assets, in_dir, seed=0):
    """16 PNGs through the port's own writer: lit renders of synthetic
    bodies (upright, camera scale 0.8) over seeded noise, 8 at 640x480
    (padded to 640², a non-integer resize to 512) and 8 at 1024x768
    (padded to 1024², cv2's exact-2x route).  Returns the names."""
    from straps_tpu_torch.render.vis import render_body_vis_batch
    from straps_tpu_torch.smpl.model import smpl_forward_axis_angle
    from straps_tpu_torch.utils.png import write_png

    dev = assets.device
    g = torch.Generator().manual_seed(seed)
    names = []
    for w, h in ((640, 480), (1024, 768)):
        poses = torch.randn(8, 72, generator=g) * 0.2
        poses[:, :3] = 0.0
        verts = smpl_forward_axis_angle(assets, (torch.randn(8, 10, generator=g) * 0.5).to(dev),
                                        poses.to(dev)).vertices
        cam = torch.tensor([0.8, 0.0, 0.0]) + torch.randn(8, 3, generator=g) * 0.03
        noise = torch.randint(0, 256, (8, w, w, 3), generator=g, dtype=torch.uint8)
        imgs = render_body_vis_batch(verts, cam.to(dev), assets, img_wh=w, image=noise.to(dev),
                                     rotate_x180=True).cpu().numpy()
        top = (w - h) // 2
        for i in range(8):
            names.append(f"{w}x{h}_{i}")
            write_png(os.path.join(in_dir, f"{names[-1]}.png"), imgs[i, top:top + h])
    return names


def person_biased(state, cls_bias=6.0, mask_bias=1.5):
    """Seeded random detectors that find people: the person class logit
    raised (the 80-class PointRend then scores a person ~0.8, not ~0.01),
    the person masks' coarse and point predictions raised, and DensePose's
    coarse segmentation foreground channels raised (so that every selected
    silhouette is mostly foreground)."""
    out = dict(state)
    for key, rows, bias in (("roi_heads.box_predictor.cls_score.bias", slice(0, 1), cls_bias),
                            ("roi_heads.mask_coarse_head.prediction.bias", slice(0, 49), mask_bias),
                            ("roi_heads.mask_point_head.predictor.bias", slice(0, 1), mask_bias),
                            ("roi_heads.densepose_predictor.ann_index_lowres.bias", slice(1, None),
                             mask_bias)):
        if key in out:
            b = out[key].clone()
            b[rows] += bias
            out[key] = b
    return out


DETECTORS = {"keypoint": "KeypointRCNN", "pointrend": "PointRendRCNN",
             "densepose": "DensePoseRCNN"}


def write_detector_pkls(d, seed=DET_SEED):
    """detectron2 pickles of the three detectors from the port's seeded
    init (`person_biased`), the RPN's box-delta weights scaled by
    `RPN_DELTA_SCALE`: (keypoint pkl, PointRend pkl, DensePose pkl).  On
    random features detectron2's 0.01 init gives box deltas of tens of
    anchor sizes (14.5 on the card-vs-CPU images), whose float error alone
    moves a proposal by 6e-3 px between card and CPU; scaled by 0.1 they
    are of order 1 (1.5-5.4), as trained ones are.  Scaled by 0.01 the
    proposals sit so near their anchors that anchor pairs at IoU 0.6996
    put NMS decisions within 1e-4 of 0.7 (seeds 1 and 2)."""
    from straps_tpu_torch.perception import rcnn
    from straps_tpu_torch.perception.convert_d2 import save_d2_pkl

    paths = []
    for cls, s, name in ((rcnn.KeypointRCNN, 2 * seed, "kp.pkl"),
                         (rcnn.PointRendRCNN, 2 * seed + 1, "pr.pkl"),
                         (rcnn.DensePoseRCNN, 2 * seed + 3, "dp.pkl")):
        with torch.device("meta"):
            model = cls()
        rcnn.init_random_weights(model, torch.Generator().manual_seed(s))
        state = person_biased(model.state_dict())
        key = "proposal_generator.rpn_head.anchor_deltas.weight"
        state[key] = state[key] * RPN_DELTA_SCALE
        paths.append(os.path.join(d, name))
        save_d2_pkl(paths[-1], state)
    return paths


def load_detector(kind, pkl, device, **kw):
    from straps_tpu_torch.perception import rcnn
    from straps_tpu_torch.perception.convert_d2 import load_d2_pkl, load_detector_state

    with torch.device("meta"):
        model = getattr(rcnn, DETECTORS[kind])(output_size=DET_FRAME, **kw)
    return load_detector_state(model, load_d2_pkl(pkl), device)


def record_calls(module, name):
    """Record the arguments and the result of every call of `module.name`
    from now on; returns (calls, restore)."""
    calls, real = [], getattr(module, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out
    setattr(module, name, wrapper)
    return calls, lambda: setattr(module, name, real)


def nms_decisions_clear(calls, margin=1e-4):
    """True when no NMS decision that shapes an output lies within `margin`
    of its IoU threshold (a kept box against a later candidate: harmless
    only where the candidate was not kept and another kept box suppresses
    it by more than the margin, or it comes after the last output).
    `calls`: the (arguments, result) of `nms_fixed` calls."""
    from straps_tpu_torch.perception.ops import pairwise_iou

    for (boxes, scores, thr, n), (idx, valid) in calls:
        for b in range(boxes.shape[0]):
            kept = idx[b][valid[b]]
            pos = torch.empty(scores.shape[1], dtype=torch.int64, device=scores.device)
            pos[torch.sort(-scores[b], stable=True).indices] = torch.arange(
                scores.shape[1], device=scores.device)
            live = torch.isfinite(scores[b]).nonzero().flatten()
            iou = pairwise_iou(boxes[b][kept], boxes[b][live])
            later = pos[live][None, :] > pos[kept][:, None]
            near = ((iou - thr).abs() <= margin) & later
            firm = ((iou > thr + margin) & later).any(0)
            last = pos[kept].max() if len(kept) == n else scores.shape[1]
            for _, j in near.nonzero().tolist():
                if bool(torch.isin(live[j], kept)) or not (firm[j] or pos[live[j]] > last):
                    return False
    return True


def _cpu(v):
    if isinstance(v, (list, tuple)):
        return [_cpu(t) for t in v]
    return v.cpu() if torch.is_tensor(v) else v


def _rel(a, b):
    """The largest difference of paired tensors, as a share of each one's
    largest value."""
    return max(float((s - t).abs().max() / t.abs().max().clamp(min=1e-30)) for s, t in zip(a, b))


def detector_stages(model, x):
    """The detector's forward on `x` with its stages recorded on the way,
    by hooks on its own modules and by wrapping the functions its trunk
    calls (no second copy of the trunk): P2-P6 (`features`), the RPN
    `logits` and `deltas`, the `proposals` after the per-level top-k and
    NMS, the `pooled` box features, `cls_score` and `bbox_pred`, DensePose's
    `SIUV` logits where the model has them, and every NMS call (`nms`).
    Returns (outputs, stages), on the CPU."""
    from straps_tpu_torch.perception import ops, rcnn

    st = {}
    heads = model.roi_heads
    hooks = [model.backbone.register_forward_hook(lambda m, a, o: st.update(features=_cpu(o))),
             model.proposal_generator.rpn_head.register_forward_hook(
                 lambda m, a, o: st.update(logits=_cpu(o[0]), deltas=_cpu(o[1]))),
             heads.box_head.register_forward_pre_hook(lambda m, a: st.update(pooled=_cpu(a[0]))),
             heads.box_predictor.register_forward_hook(
                 lambda m, a, o: st.update(cls_score=_cpu(o[0]), bbox_pred=_cpu(o[1])))]
    if hasattr(heads, "densepose_predictor"):
        hooks.append(heads.densepose_predictor.register_forward_hook(
            lambda m, a, o: st.update(SIUV=_cpu(o))))
    nms, restore_nms = record_calls(ops, "nms_fixed")
    proposals, restore_proposals = record_calls(rcnn, "generate_proposals")
    try:
        with torch.inference_mode():
            out = model(x)
    finally:
        restore_nms()
        restore_proposals()
        for hook in hooks:
            hook.remove()
    st["proposals"] = _cpu(proposals[0][1])
    st["nms"] = _cpu(nms)
    return {k: v.cpu() for k, v in out.items()}, st


def drift_by_stage(k, c):
    """Each stage of the card's forward `k` between the RPN outputs and the
    boxes against the CPU's `c` (`detector_stages`), in the network frame.
    Near-equal RPN scores may sort in another order on the card, so each
    card proposal is compared with its nearest valid CPU proposal (its own
    rank's where that is as near), and the per-proposal stages through
    that match.  Returns the report."""
    props_c, _, valid_c = c["proposals"]
    props, _, valid = k["proposals"]
    B, P = valid_c.shape
    dist = torch.where(valid_c[:, None],
                       (props[:, :, None] - props_c[:, None]).abs().amax(-1), torch.inf)
    same = dist.diagonal(dim1=1, dim2=2)
    dist, match = dist.min(-1)
    match = torch.where(same <= dist, torch.arange(P), match)
    flat = (torch.arange(B)[:, None] * P + match)[valid]
    sel = valid.flatten()
    return (f"RPN logits {_rel(k['logits'], c['logits']):.3e} of the largest, deltas "
            f"{max(float((a - b).abs().max()) for a, b in zip(k['deltas'], c['deltas'])):.3e} "
            f"abs (largest {max(float(d.abs().max()) for d in c['deltas']):.3f}); proposals "
            f"{float(dist[valid].max()):.3e} px from their nearest CPU proposal "
            f"({int(valid.sum())} valid, CPU {int(valid_c.sum())}; "
            f"{int((match != torch.arange(P))[valid].sum())} at another rank); pooled box "
            f"features {_rel([k['pooled'][sel]], [c['pooled'][flat]]):.3e} of the largest; "
            f"cls_score {float((k['cls_score'][sel] - c['cls_score'][flat]).abs().max()):.3e}, "
            f"bbox_pred {float((k['bbox_pred'][sel] - c['bbox_pred'][flat]).abs().max()):.3e} abs")


# The card-vs-CPU bound on the detections' boxes, in px of the 512 frame:
# about 3x the largest drift measured with `RPN_DELTA_SCALE` (DensePose
# R101, 6.1e-3 px on an H100; the R50 detectors 2.5e-4 and 3.2e-4 px).
BOX_BOUND_PX = 2e-2


def detector_card_vs_cpu(kind, pkl, images, test_size=256):
    """One detector on the card and on the CPU, float32, on the same images
    at `test_size`, its stages recorded (`detector_stages`): P2-P6 and the
    RPN outputs as shares of each tensor's largest value, the stages
    between them and the boxes (`drift_by_stage`), the detections as the
    JAX parity tests hold them (boxes in px, keypoints 0.1 px, masks by
    the share of equal pixels); for DensePose the S/I/U/V logits as shares
    of each tensor's largest value, and the frame part maps compared only
    on detections whose integer paste geometry (origin and size, what
    `paste_part_labels` truncates) agrees on both devices, the others
    counted.  The CPU run's NMS decisions must clear their thresholds by
    1e-4.  Returns the report line."""
    from straps_tpu_torch.perception.frontend import pil_bilinear_resize_u8
    from straps_tpu_torch.perception.rcnn import normalise_image_device

    runs = {}
    for device in ("cuda", "cpu"):
        model = load_detector(kind, pkl, device,
                              **({"output_part_maps": True} if kind == "densepose" else {}))
        x = normalise_image_device(pil_bilinear_resize_u8(images.to(device), test_size,
                                                          test_size))
        runs[device] = detector_stages(model, x)
    (ok, k), (oc, c) = runs["cuda"], runs["cpu"]
    clear = nms_decisions_clear(c["nms"])
    d_feat = _rel(k["features"], c["features"])
    d_rpn = _rel(k["logits"] + k["deltas"], c["logits"] + c["deltas"])
    valid = oc["valid"]
    same_valid = torch.equal(ok["valid"], valid)
    d_box = float((ok["boxes"] - oc["boxes"])[valid].abs().max()) if valid.any() else 0.0
    line = (f"reference check, {DETECTORS[kind]} R{101 if kind == 'densepose' else 50}-FPN on "
            f"{images.shape[0]} images at {test_size}x{test_size} f32, card vs CPU: NMS "
            f"decisions clear of their thresholds {clear}, FPN features {d_feat:.3e} and RPN "
            f"outputs {d_rpn:.3e} of each tensor's largest (bound 1e-4), valid detections "
            f"equal {same_valid} ({int(valid.sum())}), boxes {d_box:.3e} px in the {DET_FRAME} "
            f"frame (bound {BOX_BOUND_PX}); by stage: {drift_by_stage(k, c)}")
    ok_all = (clear and d_feat <= 1e-4 and d_rpn <= 1e-4 and same_valid
              and d_box <= BOX_BOUND_PX and bool(valid.any()))
    if kind == "keypoint":
        near = ((ok["keypoints"] - oc["keypoints"]).abs().amax(-1) < 0.1)[valid]
        share = float(near.float().mean()) if valid.any() else 1.0
        line += f"; keypoints within 0.1 px {share:.4f} (bound 0.9)"
        ok_all = ok_all and share >= 0.9
    elif kind == "pointrend":
        agree = float((ok["masks"] == oc["masks"])[valid].float().mean()) if valid.any() else 1.0
        line += f"; mask pixels equal {agree:.5f} (bound 0.99)"
        ok_all = ok_all and agree > 0.99
    else:
        def geometry(boxes):
            return torch.stack([torch.trunc(boxes[..., 0]), torch.trunc(boxes[..., 1]),
                                torch.trunc(boxes[..., 2] - boxes[..., 0]).clamp(min=1),
                                torch.trunc(boxes[..., 3] - boxes[..., 1]).clamp(min=1)], -1)
        same_geo = (geometry(ok["boxes"]) == geometry(oc["boxes"])).all(-1) & valid
        agree = (float((ok["part_map"] == oc["part_map"])[same_geo].float().mean())
                 if same_geo.any() else 1.0)
        d_logits = {name: _rel([a], [b]) for name, a, b in zip("SIUV", k["SIUV"], c["SIUV"])}
        line += ("; logits of each tensor's largest "
                 + ", ".join(f"{n} {v:.3e}" for n, v in d_logits.items())
                 + f" (bound 1e-2); part maps on the {int(same_geo.sum())} detections whose "
                 f"integer paste geometry agrees: pixels equal {agree:.5f} (bound 0.99); "
                 f"{int(valid.sum() - same_geo.sum())} detections with another integer "
                 f"geometry on the card, not compared")
        ok_all = ok_all and max(d_logits.values()) <= 1e-2 and agree > 0.99
    if not ok_all:
        raise AssertionError(line)
    return line


def detector_times(card, pkls, images):
    """Per detector, at the full configuration (800² test size, 512
    proposals, 8 detections, 5 subdivision steps) on one chunk of 8 of
    `images`: the CUDA-synchronised forward in float32 and with the
    bfloat16 backbone (median of 5 after a warm-up), peak device memory,
    and NMS's share of one forward (each NMS call fenced by
    synchronisations) with its host synchronisations."""
    from straps_tpu_torch.perception import ops
    from straps_tpu_torch.perception.frontend import pil_bilinear_resize_u8
    from straps_tpu_torch.perception.rcnn import normalise_image_device

    x = normalise_image_device(pil_bilinear_resize_u8(images[:8], DET_TEST, DET_TEST))
    for kind, pkl in zip(("keypoint", "pointrend"), pkls):
        for dtype in (None, "bfloat16"):
            model = load_detector(kind, pkl, "cuda", backbone_dtype=dtype)
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                times = synced_ms(lambda: model(x), warm=1, reps=5)
                # The stages by differences of minimums: the host's jitter
                # (tens of ms between calls) only ever adds.
                trunk = min(synced_ms(lambda: model.trunk(x), warm=0, reps=5))
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype is not None):
                    bb = min(synced_ms(lambda: model.backbone(x), warm=0, reps=5))
                nms_ms, real = [], ops.nms_fixed

                def timed(*args, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = real(*args, **kw)
                    torch.cuda.synchronize()
                    nms_ms.append((time.perf_counter() - t0) * 1e3)
                    return out
                ops.nms_fixed = timed
                syncs0 = dict(ops.NMS_STATS)
                try:
                    fenced = synced_ms(lambda: model(x), warm=0, reps=1)[0]
                finally:
                    ops.nms_fixed = real
            syncs = {k: ops.NMS_STATS[k] - syncs0[k] for k in syncs0}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            med = float(np.median(times))
            print(f"times on {card}: {kind} R50-FPN forward, chunk of 8 at {DET_TEST}x{DET_TEST}, "
                  f"backbone {dtype or 'float32'}: median {med:.2f} ms (min {min(times):.2f}, "
                  f"max {max(times):.2f}; {8e3 / med:.2f} images/s), peak device memory "
                  f"{peak:.2f} GiB; NMS {sum(nms_ms):.2f} ms of a fenced forward of "
                  f"{fenced:.2f} ms ({100 * sum(nms_ms) / fenced:.1f}%) in {len(nms_ms)} calls, "
                  f"{syncs['blocks']} blocks, {syncs['syncs']} host synchronisations; stages "
                  f"(minimums of 5): backbone + FPN {bb:.2f} ms, RPN + proposals + box head + "
                  f"detections {trunk - bb:.2f} ms, the {kind} head {min(times) - trunk:.2f} ms")
            del model


def densepose_times(card, pkl, images):
    """DensePose-RCNN R101-FPN at the full configuration (800² test size,
    512 proposals, 8 detections, 512 frame) on one chunk of 8 of `images`:
    the CUDA-synchronised forward in float32 and with the bfloat16
    backbone (median of 5 after a warm-up), its stages by differences of
    minimums of 5 (backbone + FPN; RPN + proposals + box head + detections;
    the DensePose pooler, head and predictor; the frame paste), peak
    device memory."""
    from straps_tpu_torch.perception.densepose import densepose_to_iuv, paste_part_labels
    from straps_tpu_torch.perception.frontend import pil_bilinear_resize_u8
    from straps_tpu_torch.perception.heads import pooled_box_features
    from straps_tpu_torch.perception.rcnn import normalise_image_device

    x = normalise_image_device(pil_bilinear_resize_u8(images[:8], DET_TEST, DET_TEST))
    for dtype in (None, "bfloat16"):
        model = load_detector("densepose", pkl, "cuda", backbone_dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            times = synced_ms(lambda: model(x), warm=1, reps=5)
            trunk = min(synced_ms(lambda: model.trunk(x), warm=0, reps=5))
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype is not None):
                bb = min(synced_ms(lambda: model.backbone(x), warm=0, reps=5))
            nhwc, boxes, _, valid = model.trunk(x)
            heads = model.roi_heads

            def head():
                roi = pooled_box_features(nhwc, boxes, 14, aligned=False, sampling_ratio=2,
                                          compute_dtype=model.compute_dtype)
                s, i, u, v = heads.densepose_predictor(heads.densepose_head(roi))
                densepose_to_iuv(s, i, u, v)
                return s, i
            head_ms = min(synced_ms(head, warm=0, reps=5))
            s, i = head()
            out_boxes = (boxes * (DET_FRAME / DET_TEST)).reshape(-1, 4)
            paste_ms = min(synced_ms(lambda: paste_part_labels(s, i, out_boxes, DET_FRAME,
                                                               DET_FRAME), warm=0, reps=5))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = float(np.median(times))
        print(f"times on {card}: DensePose-RCNN R101-FPN forward, chunk of 8 at "
              f"{DET_TEST}x{DET_TEST} ({int(valid.sum())} detections), backbone "
              f"{dtype or 'float32'}: median {med:.2f} ms (min {min(times):.2f}, max "
              f"{max(times):.2f}; {8e3 / med:.2f} images/s), peak device memory {peak:.2f} GiB; "
              f"stages (minimums of 5): backbone + FPN {bb:.2f} ms, RPN + proposals + box head + "
              f"detections {trunk - bb:.2f} ms, DensePose pooler + head + predictor "
              f"{head_ms:.2f} ms, frame paste of {out_boxes.shape[0]} boxes {paste_ms:.2f} ms "
              f"(the rest {min(times) - trunk - head_ms - paste_ms:.2f} ms)")
        del model


def run_image_predict(pipe, run_predict, argv):
    """The predict CLI over images with its stages timed on the host clock
    (each fenced by CUDA synchronisations) and the detectors' outputs
    recorded on their way.  Returns (prediction, wall s, {stage: s},
    [keypoint outputs, silhouette outputs])."""
    det_outs, stage_s, real = [], {}, {}

    def timed(name, label, record=False):
        real[name] = getattr(pipe, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[label] = stage_s.get(label, 0.0) + time.perf_counter() - t
            if record:
                det_outs.append(out)
            return out
        setattr(pipe, name, wrapper)
    timed("read_images", "image reads, padding and resizes to 512")
    timed("build_detector_models", "detectors built from their pickles")
    timed("run_detector_batched", "both detectors (first calls)", record=True)
    timed("load_regressor_variables", "regressor built and loaded")
    timed("render_body_vis_batch", "body renders")
    timed("write_verts_vis", "verts_vis figures")
    timed("write_png", "PNG writes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            pred = run_predict.main(argv)
    finally:
        for name, fn in real.items():
            setattr(pipe, name, fn)
    torch.cuda.synchronize()
    return pred, time.perf_counter() - t0, stage_s, det_outs


def check_image_predict(label, pred, out_dir, det_outs, assets, ckpt, run_predict, faceid_errs):
    """What every image predict must show: detections of both detectors on
    every image, finite npy outputs, the rend / reposed / silhouette /
    joints PNGs, the face-id kernel bit for bit on the inputs of its two
    launches (their errors appended to `faceid_errs`), and a rerun over
    the proxies the run cached that gives identical npy outputs."""
    from straps_tpu_torch.predict.pipeline import REPOSED_CAM_WP

    kp_out, silh_out = det_outs
    for i, name in enumerate(pred["names"]):
        sil = np.load(os.path.join(out_dir, "proxies", f"{name}_silhouette.npy"))
        areas = silh_out["masks"][i][silh_out["valid"][i]].sum(axis=(1, 2)).tolist()
        print(f"  {name}: keypoint detections {int(kp_out['valid'][i].sum())}, {label} "
              f"detections {int(silh_out['valid'][i].sum())} (mask areas {areas} px), "
              f"selected silhouette {int(sil.sum())} px")
    if not all(kp_out["valid"].any(1)) or not all(silh_out["valid"].any(1)):
        raise AssertionError(f"{label}: an image without detections")
    for name in pred["names"]:
        for key in ("verts", "shape", "pose_rotmats", "cam_wp"):
            if not np.isfinite(np.load(os.path.join(out_dir, f"{name}_{key}.npy"))).all():
                raise AssertionError(f"non-finite {name}_{key}.npy")
        for f in (f"rend_vis/rend_{name}.png", f"rend_vis/reposed_{name}.png",
                  f"proxy_vis/silhouette_{name}.png"):
            decode_png(os.path.join(out_dir, f))
        joints = decode_png(os.path.join(out_dir, "proxy_vis", f"joints2D_{name}.png"))
        red = int((joints == np.array([255, 0, 0], np.uint8)).all(-1).sum())
        figure = decode_png(os.path.join(out_dir, "verts_vis", f"verts_{name}.png"))
        if figure.shape != (480, 640, 4) or red == 0:
            raise AssertionError(f"{name}: verts_vis {figure.shape} (want 480x640 RGBA) or "
                                 f"joints2D without red index text ({red} px)")
    n = len(pred["names"])
    faceid_errs.append(compare_faceid(
        f"{label} image predict rend B={n} 256x256",
        *vis_faceid_inputs(assets, pred["verts"], pred["cam_wp"], 256), 256, 256))
    faceid_errs.append(compare_faceid(
        f"{label} image predict reposed B={n} 256x256",
        *vis_faceid_inputs(assets, pred["reposed_verts"], torch.tensor(REPOSED_CAM_WP).expand(n, 3),
                           256, rotate_x180=True), 256, 256))
    cached_out = out_dir + "_cached"
    with contextlib.redirect_stdout(io.StringIO()):
        run_predict.main(["--input", os.path.join(out_dir, "proxies"), "--checkpoint", ckpt,
                          "--out-dir", cached_out, "--device", "cuda", "--no-vis"])
    same = all(np.array_equal(np.load(os.path.join(out_dir, f"{name}_{key}.npy")),
                              np.load(os.path.join(cached_out, f"{name}_{key}.npy")))
               for name in pred["names"] for key in ("verts", "shape", "pose_rotmats", "cam_wp"))
    print(f"slice: rerun over the {n} cached proxies of the {label} predict: npy outputs "
          f"identical {same}")
    if not same:
        raise AssertionError(f"the cached proxies do not reproduce the {label} image predict")


def write_ssp3d_layout(root, assets, n, seed, size=512):
    """An SSP-3D release layout: `labels.npz` (poses, shapes, genders,
    (n, 17, 3) joints2D, fnames) and `silhouettes/<fname>` grey PNGs of n
    synthetic bodies rendered at `size`x`size` (the joints projected in
    the same frame)."""
    from straps_tpu_torch.eval_harness.runner import synthesise_proxy_inputs
    from straps_tpu_torch.utils.png import write_png

    rng = np.random.RandomState(seed)
    poses = (rng.randn(n, 72) * 0.2).astype(np.float32)
    shapes = (rng.randn(n, 10) * 0.5).astype(np.float32)
    sils, j2d = synthesise_proxy_inputs(poses, shapes, assets, size)
    fnames = [f"image_{i:05d}.png" for i in range(n)]
    for f, sil in zip(fnames, sils):
        write_png(os.path.join(root, "silhouettes", f), (sil > 0).astype(np.uint8) * 255)
    np.savez(os.path.join(root, "labels.npz"), fnames=np.asarray(fnames), shapes=shapes,
             poses=poses, genders=np.asarray(["m", "f"] * (n // 2)),
             joints2D=np.concatenate([j2d, np.ones((n, 17, 1), np.float32)], -1))


# Phase 4m's colour forms of a silhouette (foreground, background): each
# has a grey read > 0 exactly on the foreground, and a channel 0 that is
# not (cv2's grey weights, 9797 R + 19234 G + 3737 B >> 15).
SILHOUETTE_PALETTE = np.array([[0, 0, 8], [0, 180, 0], [0, 0, 255], [90, 0, 0]], np.uint8)


def codings_folder(folder, img_dir, jpeg_dir, png_bytes):
    """Phase 4m's predict input: 4 of phase 4d's body images rewritten as
    an interlaced palette PNG (3-3-2 colours), a 16-bit RGB PNG, a 1-bit
    grey PNG and an interlaced 16-bit grey PNG; the arithmetic-coded,
    lossless and cut JPEG fixtures, a 600x452 progressive fixture cut at
    half its length, and an arithmetic JPEG named `.png`."""
    from straps_tpu_torch.utils.png import decode_png as port_decode_png

    os.makedirs(folder)
    bodies = sorted(os.listdir(img_dir))[:4]
    imgs = [port_decode_png(os.path.join(img_dir, b)).astype(np.int64) for b in bodies]
    luma = [(img @ np.array([299, 587, 114])) // 1000 for img in imgs]
    pal = np.array([[r * 255 // 7, g * 255 // 7, b * 255 // 3]
                    for r in range(8) for g in range(8) for b in range(4)])
    idx = (imgs[0][..., 0] >> 5 << 5) | (imgs[0][..., 1] >> 5 << 2) | (imgs[0][..., 2] >> 6)
    writes = {
        "body_palette_adam7.png": png_bytes(idx[..., None], 3, 8, palette=pal, interlace=1),
        "body_rgb16.png": png_bytes(imgs[1] * 256 + (imgs[1] * 7 & 255), 2, 16, idat_parts=3),
        "body_grey1.png": png_bytes((luma[2] > 96)[..., None].astype(np.int64), 0, 1),
        "body_grey16_adam7.png": png_bytes((luma[3] * 257)[..., None], 0, 16, interlace=1),
    }
    with open(os.path.join(jpeg_dir, "progressive_420.jpg"), "rb") as f:
        data = f.read()
    writes["progressive_420_cut.jpg"] = data[:len(data) // 2]
    with open(os.path.join(jpeg_dir, "arith_prog_444_rst.jpg"), "rb") as f:
        writes["arith_named.png"] = f.read()
    for name, data in writes.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
    for name in ("arith_seq_420.jpg", "arith_prog_420.jpg", "lossless_p1.jpg",
                 "lossless_p4_cmyk.jpg", "huff_prog_420_cut.jpg", "arith_prog_420_cut.jpg"):
        os.symlink(os.path.join(jpeg_dir, name), os.path.join(folder, name))


def image_codings(card, dev, assets, pipe, run_predict, run_eval, work, img_dir, pkls,
                  ckpt_pred, ckpt, ssp3d, batch, corpora, faceid_errs):
    """Phase 4m: every PNG and JPEG form that cv2.imread reads.  (a) The
    committed fixtures decoded and held to cv2's hashes, the codings cv2
    refuses refused; (b) the predict CLI over PNG and JPEG forms through
    PointRend at full width; (c) the release-layout eval on silhouettes
    stored as palette, coloured and 16-bit PNGs against the same layout in
    8-bit grey; (d) one train epoch on the synthetic body model of seed 3.
    Returns (face-id launches of (b), packed launches of (c) and (d))."""
    from straps_tpu_torch.config import TrainConfig
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.smpl.assets import load_synthetic_assets
    from straps_tpu_torch.train.loop import train
    from straps_tpu_torch.utils import png as port_png
    from straps_tpu_torch.utils.jpeg import decode_jpeg
    sys.path.insert(0, os.path.join(HERE, "tests", "torch_png"))
    from pngwriter import png_bytes

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa
    # (a) Fixtures.
    png_dir = os.path.join(HERE, "tests", "torch_png")
    jpeg_dir = os.path.join(HERE, "tests", "torch_jpeg")
    with open(os.path.join(png_dir, "expected.json")) as f:
        png_expected = json.load(f)
    for name, want in sorted(png_expected.items()):
        path = os.path.join(png_dir, name)
        colour, grey = port_png.decode_png(path), port_png.decode_png_grey(path)
        same = (list(colour.shape) == want["shape"] and digest(colour) == want["sha256"]
                and digest(grey) == want["grey_sha256"])
        ms = host_ms(lambda: port_png.decode_png(path))
        grey_ms = host_ms(lambda: port_png.decode_png_grey(path))
        print(f"png: {name} {colour.shape[1]}x{colour.shape[0]} colour and grey reads equal to "
              f"cv2.imread's hashes {same}; decode_png {ms:.3f} ms, decode_png_grey "
              f"{grey_ms:.3f} ms (host, median of 5, {card})")
        if not same:
            raise AssertionError(f"{name}: decoded pixels differ from cv2.imread's")
    with open(os.path.join(jpeg_dir, "expected.json")) as f:
        jpeg_expected = json.load(f)
    for name, want in sorted(jpeg_expected.items()):
        path = os.path.join(jpeg_dir, name)
        if want is None:
            try:
                decode_jpeg(path)
            except ValueError as e:
                print(f"jpeg: {name}: refused as cv2.imread refuses it ({e})")
                continue
            raise AssertionError(f"{name}: decoded, where cv2.imread reads no image")
        px = decode_jpeg(path)
        same = list(px.shape) == want["shape"] and digest(px) == want["sha256"]
        ms = host_ms(lambda: decode_jpeg(path))
        print(f"jpeg: {name} {px.shape[1]}x{px.shape[0]} equal to cv2.imread's hash {same}; "
              f"decode_jpeg {ms:.3f} ms (host, median of 5, {card})")
        if not same:
            raise AssertionError(f"{name}: decoded pixels differ from cv2.imread's")
    rng = np.random.default_rng(14)
    idx = rng.integers(0, 256, (768, 1024, 1))
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    big = png_bytes(idx, 3, 8, palette=pal, interlace=1)
    if not np.array_equal(port_png.decode_png_bytes(big), pal[idx[..., 0]]):
        raise AssertionError("1024x768 palette Adam7 PNG: pixels differ from its palette's")
    big_ms = host_ms(lambda: port_png.decode_png_bytes(big))
    arith = os.path.join(jpeg_dir, "arith_prog_420.jpg")
    arith_ms = host_ms(lambda: decode_jpeg(arith))
    print(f"times on {card}: decode_png of a 1024x768 palette Adam7 PNG ({len(big)} bytes) "
          f"{big_ms:.3f} ms; decode_jpeg of the 600x452 arithmetic-coded progressive 4:2:0 "
          f"JPEG ({os.path.getsize(arith)} bytes) {arith_ms:.3f} ms (host, medians of 5)")

    # (b) The predict CLI over the PNG and JPEG forms.
    folder = os.path.join(work, "codings")
    codings_folder(folder, img_dir, jpeg_dir, png_bytes)
    out = os.path.join(work, "predict_codings")
    reset_launches()
    pred, wall, stage_s, det_outs = run_image_predict(
        pipe, run_predict, ["--input", folder, "--silh-from", "pointrend",
                            "--keypoint-checkpoint", pkls[0], "--silhouette-checkpoint", pkls[1],
                            "--checkpoint", ckpt_pred, "--device", "cuda", "--out-dir", out])
    codings_launches = CR.faceid_raster_kernel.launches
    print(f"slice: predict of {len(pred['names'])} PNG and JPEG forms through Keypoint-RCNN + "
          f"PointRend R50-FPN at {DET_TEST}x{DET_TEST}, frame {DET_FRAME}, first run: "
          f"{wall:.3f} s wall, face-id kernel launches {codings_launches} (rend 1 + reposed 1); "
          f"of the wall: " + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items()))
    if codings_launches != 2 or len(pred["names"]) != len(os.listdir(folder)):
        raise AssertionError(f"codings predict: {len(pred['names'])} images, "
                             f"{codings_launches} face-id launches")
    check_image_predict("PointRend (PNG and JPEG forms)", pred, out, det_outs, assets, ckpt_pred,
                        run_predict, faceid_errs)

    # (c) The release layout with its silhouettes stored in other forms.
    variants = os.path.join(work, "ssp_3d_forms")
    os.makedirs(os.path.join(variants, "silhouettes"))
    shutil.copy(os.path.join(ssp3d, "labels.npz"), variants)
    names = sorted(os.listdir(os.path.join(ssp3d, "silhouettes")))
    forms = []
    for i, name in enumerate(names):
        fg = port_png.decode_png_grey(os.path.join(ssp3d, "silhouettes", name)) > 0
        form = ("palette", "coloured", "grey16")[i % 3]
        if form == "palette":
            data = png_bytes(np.where(fg, 1 + (np.arange(fg.shape[1]) % 3), 0)[..., None], 3, 2,
                             palette=SILHOUETTE_PALETTE)
        elif form == "coloured":
            data = png_bytes(np.where(fg[..., None], [0, 200, 0], [0, 0, 8]), 2, 8)
        else:
            data = png_bytes(np.where(fg, 40000 + (np.arange(fg.shape[1]) % 251), 255)[..., None],
                             0, 16)
        with open(os.path.join(variants, "silhouettes", name), "wb") as f:
            f.write(data)
        forms.append(form)
    metrics, launches = {}, {}
    for label, root in (("8-bit grey", ssp3d), ("palette, coloured, 16-bit", variants)):
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics[label] = run_eval.main(["--dataset", root, "--checkpoint", ckpt, "--img-wh",
                                            "256", "--batch-size", str(batch), "--iou-frame",
                                            "image", "--device", "cuda"])
        launches[label] = CR.packed_raster_kernel.launches
    grey_m, forms_m = metrics.values()
    print(f"slice: eval of the {len(names)}-sample SSP-3D layout with its silhouettes as "
          f"{forms.count('palette')} palette, {forms.count('coloured')} coloured and "
          f"{forms.count('grey16')} 16-bit PNGs: silhouette IoU "
          f"{forms_m['silhouette_ious']:.6f} against {grey_m['silhouette_ious']:.6f} from 8-bit "
          f"grey PNGs, every metric equal {forms_m == grey_m}; packed kernel launches "
          f"{list(launches.values())}")
    if forms_m != grey_m or any(v != len(names) // batch for v in launches.values()):
        raise AssertionError(f"release layout in other PNG forms: {forms_m} vs {grey_m}, "
                             f"launches {launches}")

    # (d) One train epoch on the body model of seed 3.
    seed3 = load_synthetic_assets(device=dev, seed=3)
    if torch.equal(seed3.posedirs, assets.posedirs):
        raise AssertionError("seed 3's body model equals seed 0's")
    cfg = TrainConfig(num_epochs=1, data_parallel_devices=1, train_path=corpora[0],
                      val_path=corpora[1])
    train_dir = os.path.join(work, "train_seed3")
    os.makedirs(train_dir)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(train_dir):
        _, _, tracker = train(cfg, assets=seed3, verbose=False, device="cuda")
    torch.cuda.synchronize()
    train_launches = CR.packed_raster_kernel.launches
    history = {k: v for k, v in tracker.history.items() if v}
    print(f"slice: one train epoch at batch {cfg.batch_size} on the synthetic body model of "
          f"seed 3 (generated, posedirs differ from seed 0's): {time.perf_counter() - t0:.3f} s "
          f"wall, packed kernel launches {train_launches}, final train loss "
          f"{history['train_losses'][-1]:.4f}")
    if train_launches != 6 or not all(np.isfinite(v).all() for v in history.values()):
        raise AssertionError(f"seed-3 epoch: {train_launches} packed launches, history {history}")
    return codings_launches, sum(launches.values()) + train_launches


def write_reference_additional_dir(root):
    """The reference's `additional/` directory, every file in its real
    on-disk format, from the committed synthetic fixture with numpy, scipy
    and pickle only: `smpl/SMPL_NEUTRAL.pkl` as the chumpy-stripped SMPL
    files ship (float64 arrays, 12 shape directions, the (V, 3, 207)
    pose directions, a scipy-sparse `J_regressor`, a uint32
    `kintree_table` with the root's parent 0xFFFFFFFF, pickle protocol 2),
    the three joint regressor npys (float64), the mean-params npz and the
    colour-cube part assets that encode the fixture's face parts.  Returns
    the `smpl/` directory."""
    import pickle
    import scipy.sparse
    from straps_tpu_torch.smpl.assets import SYNTHETIC_ASSETS

    with np.load(SYNTHETIC_ASSETS) as f:
        arrs = dict(f)
    smpl_dir = os.path.join(root, "smpl")
    os.makedirs(smpl_dir)
    V = arrs["v_template"].shape[0]
    kintree = np.zeros((2, 24), np.uint32)
    kintree[0] = arrs["parents"].astype(np.int64).astype(np.uint32)
    kintree[0, 0] = np.uint32(0xFFFFFFFF)
    kintree[1] = np.arange(24, dtype=np.uint32)
    smpl = {"v_template": arrs["v_template"].astype(np.float64),
            "shapedirs": np.concatenate([arrs["shapedirs"], np.zeros((V, 3, 2))],
                                        axis=2).astype(np.float64),
            "posedirs": arrs["posedirs"].T.reshape(V, 3, 207).astype(np.float64),
            "J_regressor": scipy.sparse.csc_matrix(arrs["J_regressor"].astype(np.float64)),
            "weights": arrs["lbs_weights"].astype(np.float64),
            "f": arrs["faces"].astype(np.uint32), "kintree_table": kintree,
            "J": arrs["J_regressor"].astype(np.float64) @ arrs["v_template"].astype(np.float64),
            "bs_style": b"lbs", "bs_type": b"lrotmin"}
    with open(os.path.join(smpl_dir, "SMPL_NEUTRAL.pkl"), "wb") as f:
        pickle.dump(smpl, f, protocol=2)
    for key, name in (("J_regressor_extra", "J_regressor_extra.npy"),
                      ("J_regressor_cocoplus", "cocoplus_regressor.npy"),
                      ("J_regressor_h36m", "J_regressor_h36m.npy")):
        np.save(os.path.join(root, name), arrs[key].astype(np.float64))
    np.savez(os.path.join(root, "neutral_smpl_mean_params_6dpose.npz"),
             pose=arrs["mean_pose_6d"], shape=arrs["mean_shape"])
    colours = (arrs["face_parts"].astype(np.float64)[:, None] * 10.0 + 0.5) / 100.0
    tex = np.zeros((1, len(colours), 2, 2, 2, 3), np.float32)
    tex[0] = colours[:, None, None, None, :]
    np.save(os.path.join(root, "vertex_texture.npy"), tex)
    cube = np.zeros((101, 101, 101), np.float64)
    for part in range(8):
        cube[10 * part, 10 * part, 10 * part] = part
    np.save(os.path.join(root, "cube_parts.npy"), cube)
    return smpl_dir


def gate_rows(text):
    """The parity gate's table: {row: (status, detail)}."""
    rows = {}
    for line in text.splitlines():
        parts = line.split("  ")
        cells = [c.strip() for c in parts if c.strip()]
        if len(cells) >= 3 and cells[1] in ("PASS", "FAIL"):
            rows[cells[0]] = (cells[1], cells[2])
    return rows



# Phase 4k: the detector training side at R101-FPN width.  Two images, 64
# training ROIs an image (one card's share of detectron2's IMS_PER_BATCH
# 16 over 8 GPUs), synthetic DensePose annotations.
TRAIN_ROIS_PER_IMAGE, TRAIN_GT_PER_IMAGE, TRAIN_POINTS = 64, 4, 128
DEEPLAB_PREFIX = "roi_heads.densepose_head."
# The port's DeepLab head names -> the JAX head's flax scopes (phase 4k's
# converter check writes a flax tree from numpy with them).
FLAX_DEEPLAB = {"ASPP.convs.0.0": "aspp/conv1x1", "ASPP.convs.0.1": "aspp/gn1x1",
                "ASPP.convs.1.0": "aspp/atrous1", "ASPP.convs.1.1": "aspp/gn_atrous1",
                "ASPP.convs.2.0": "aspp/atrous2", "ASPP.convs.2.1": "aspp/gn_atrous2",
                "ASPP.convs.3.0": "aspp/atrous3", "ASPP.convs.3.1": "aspp/gn_atrous3",
                "ASPP.convs.4.1": "aspp/pool_conv", "ASPP.convs.4.2": "aspp/gn_pool",
                "ASPP.project.0": "aspp/project", "NLBlock.theta": "nonlocal/theta",
                "NLBlock.phi.0": "nonlocal/phi", "NLBlock.g.0": "nonlocal/g",
                "NLBlock.W.0": "nonlocal/W", "NLBlock.W.1": "nonlocal/gn_w"}


def synthetic_training_targets(frame_size, seed=12):
    """Training ROIs and their DensePose targets for 2 images of
    `frame_size`: 4 ground-truth people an image (the last without a
    DensePose annotation), 64 proposals an image as seeded jitters of them
    (some above and some below IoU 0.7 with their own box), and for each
    annotated person a `DensePoseDataRelative` (14 RLE part masks, 64-128
    points with dp_I in 1..24 and U, V in [0, 1]), every other one flipped
    through `DensePoseTransformData.synthetic()`.  The annotation is read
    in each proposal's frame as detectron2 reads it: points (box-relative
    [0, 1], those outside the proposal invalid), the coarse segmentation
    at the 56x56 cell centres and the person mask at 28x28.  Returns
    (proposals (2, 64, 4), matched gt boxes (128, 4), has_densepose (128,),
    targets {name: tensor}), on the CPU."""
    from straps_tpu_torch.perception.densepose_structures import (
        MASK_SIZE, N_BODY_PARTS, DensePoseDataRelative, DensePoseTransformData, rle_encode)

    rng = np.random.RandomState(seed)
    n_img, per, n_gt = 2, TRAIN_ROIS_PER_IMAGE, TRAIN_GT_PER_IMAGE
    wh = rng.uniform([0.2, 0.35], [0.4, 0.6], (n_img, n_gt, 2)) * frame_size
    xy = rng.uniform(0.02, 1.0, (n_img, n_gt, 2)) * (frame_size * 0.98 - wh)
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    yy, xx = np.mgrid[:MASK_SIZE, :MASK_SIZE]
    anns, flip = [], DensePoseTransformData.synthetic()
    for k in range(n_img * n_gt):
        if k % n_gt == n_gt - 1:
            anns.append(None)
            continue
        masks = []
        for p in range(N_BODY_PARTS):
            cy, cx = rng.uniform(40, 216, 2)
            ry, rx = rng.uniform(12, 60, 2)
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.uint8)
            masks.append(rle_encode(m) if p % 3 else [])
        n = rng.randint(64, TRAIN_POINTS + 1)
        data = DensePoseDataRelative({
            "dp_x": rng.uniform(0, MASK_SIZE, n), "dp_y": rng.uniform(0, MASK_SIZE, n),
            "dp_I": rng.randint(1, 25, n), "dp_U": rng.uniform(0, 1, n),
            "dp_V": rng.uniform(0, 1, n), "dp_masks": masks})
        if k % 2:
            data.apply_hflip(flip)
        anns.append(data)
    R = n_img * per
    match = np.arange(R) // per * n_gt + np.arange(R) % n_gt
    gt_flat = gt.reshape(-1, 4)[match]
    size = np.tile(gt_flat[:, 2:] - gt_flat[:, :2], 2)
    props = gt_flat + rng.normal(0, 1, (R, 4)) * size * rng.choice([0.02, 0.05, 0.12], (R, 1))
    props = np.clip(props, 0, frame_size - 1).astype(np.float32)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 4)
    P = TRAIN_POINTS
    t = {"gt_segm": np.zeros((R, 56, 56), np.int64), "gt_mask28": np.zeros((R, 28, 28), np.float32),
         "gt_points01": np.zeros((R, P, 2), np.float32), "gt_part": np.zeros((R, P), np.int64),
         "gt_u": np.zeros((R, P), np.float32), "gt_v": np.zeros((R, P), np.float32),
         "point_valid": np.zeros((R, P), bool)}
    for r in range(R):
        data = anns[match[r]]
        if data is None:
            continue
        g, b = gt_flat[r], props[r]
        # Annotation points: GT-box grid (0..256) -> image -> proposal [0, 1].
        px = g[0] + data.x / MASK_SIZE * (g[2] - g[0])
        py = g[1] + data.y / MASK_SIZE * (g[3] - g[1])
        p01 = np.stack([(px - b[0]) / (b[2] - b[0]), (py - b[1]) / (b[3] - b[1])], -1)
        n = len(p01)
        t["gt_points01"][r, :n] = p01
        t["point_valid"][r, :n] = ((p01 >= 0) & (p01 < 1)).all(-1)
        t["gt_part"][r, :n], t["gt_u"][r, :n], t["gt_v"][r, :n] = data.i, data.u, data.v
        for side, key in ((56, "gt_segm"), (28, "gt_mask28")):
            c = (np.arange(side) + 0.5) / side
            gx = ((b[0] + c * (b[2] - b[0]) - g[0]) / (g[2] - g[0]) * MASK_SIZE).astype(np.int64)
            gy = ((b[1] + c * (b[3] - b[1]) - g[1]) / (g[3] - g[1]) * MASK_SIZE).astype(np.int64)
            inside = ((gy >= 0) & (gy < MASK_SIZE))[:, None] & ((gx >= 0) & (gx < MASK_SIZE))[None]
            seg = np.where(inside, data.segm[gy.clip(0, MASK_SIZE - 1)][:, gx.clip(0, MASK_SIZE - 1)],
                           0)
            t[key][r] = seg if key == "gt_segm" else (seg > 0)
    has_dp = np.asarray([anns[m] is not None for m in match])
    return (torch.as_tensor(props).view(n_img, per, 4), torch.as_tensor(gt_flat),
            torch.as_tensor(has_dp), {k: torch.as_tensor(v) for k, v in t.items()})


def flax_deeplab_tree(state):
    """The JAX `DensePoseDeepLabHead`'s flax variables for a port head's
    state dict, written from numpy (convolutions OIHW -> HWIO, GroupNorm
    weight -> scale), under the DensePose-RCNN's `densepose_head` scope."""
    tree = {}
    for name, v in state.items():
        module, leaf = name.rsplit(".", 1)
        if module in FLAX_DEEPLAB:
            path = FLAX_DEEPLAB[module].split("/")
        elif module.endswith(".norm"):
            path = ["gn" + module.split(".")[0][len("body_conv_fcn"):]]
        else:
            path = [module]
        a = v.detach().cpu().numpy()
        if a.ndim == 4:
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": {"densepose_head": tree}}


# The NonLocal block's phi bias has a zero gradient in exact arithmetic:
# it shifts every key by the same vector, and the softmax over the keys
# ignores a shift a query's logits share.  Its computed gradient is
# rounding on both devices, so it is held against the scale of its
# weight's gradient instead of its own.
ZERO_GRADIENT_OF = {"NLBlock.phi.0.bias": "NLBlock.phi.0.weight"}


def _grad_report(named_k, named_c):
    """Each parameter's gradient on the card against the CPU's, as a share
    of the CPU gradient's largest value (for `ZERO_GRADIENT_OF`, of its
    weight's).  Returns (worst share, its name)."""
    grads_c = {name: p.grad for name, p in named_c}
    worst, worst_name = 0.0, ""
    for name, pk in named_k:
        scale = float(grads_c[ZERO_GRADIENT_OF.get(name, name)].abs().max())
        d = float((pk.grad.cpu() - grads_c[name]).abs().max())
        share = d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))
        if share > worst:
            worst, worst_name = share, name
    return worst, worst_name


def detector_training_side(card, pkls, frames):
    """Phase 4k.  (a) DensePose: the DensePose-RCNN R101-FPN trunk at
    800x800 on the 2 frames, 128 training ROIs through
    `densepose_data_filter`, the legacy 14x14 pooler (ratio 2), the DeepLab
    head (conv_dim 512, 8 stacked convs, ASPP (6, 12, 56), NonLocal on, its
    GroupNorm randomised so that the block is exercised), the predictor to
    56x56, `densepose_losses` and the backward to the head's and the
    predictor's parameters, on the card and on the CPU from the card's
    pooled features (the head runs over all 128 ROIs; the filtered ones
    reach no loss term, so the gradients are the filtered batch's); times in
    float32 and under bfloat16 autocast.  (b) PointRend: the PointRend-RCNN
    P2 features, the coarse head at 7x7 on the 128 ROIs, 196 importance
    points (x3, 0.75) drawn on the card, the point head, `mask_point_loss`
    against 28x28 masks and the backward; the CPU given the card's draws.
    (c) The DeepLab head's state through a detectron2 pickle and through a
    flax tree.  Raises on any failure; returns the phase's report lines."""
    import copy

    from straps_tpu_torch.perception import densepose as TD
    from straps_tpu_torch.perception import pointrend as TPR
    from straps_tpu_torch.perception.convert_d2 import (
        flax_detector_to_torch_state_dict, load_d2_pkl, load_detector_state, save_d2_pkl)
    from straps_tpu_torch.perception.frontend import pil_bilinear_resize_u8
    from straps_tpu_torch.perception.heads import pooled_box_features
    from straps_tpu_torch.perception.ops import pairwise_iou, roi_align
    from straps_tpu_torch.perception.rcnn import normalise_image_device

    dev = torch.device("cuda")
    lines = []
    x = normalise_image_device(pil_bilinear_resize_u8(frames.to(dev), DET_TEST, DET_TEST))
    props, gt_boxes, has_dp, targets = synthetic_training_targets(DET_TEST)
    R = props.shape[0] * props.shape[1]
    keep = TD.densepose_data_filter(props.view(-1, 4).to(dev), gt_boxes.to(dev), has_dp.to(dev),
                                    torch.ones(R, dtype=torch.bool, device=dev))
    iou = pairwise_iou(props.view(-1, 1, 4), gt_boxes[:, None])[:, 0, 0]
    keep_cpu = TD.densepose_data_filter(props.view(-1, 4), gt_boxes, has_dp,
                                        torch.ones(R, dtype=torch.bool))
    if not torch.equal(keep.cpu(), keep_cpu) or keep_cpu.all() or not keep_cpu.any():
        raise AssertionError("densepose_data_filter: card and CPU differ, or it keeps all or none")
    n_keep = int(keep_cpu.sum())

    # (a) DensePose.
    model = load_detector("densepose", pkls[2], dev)
    with torch.inference_mode():
        nhwc = model.trunk(x)[0]
        roi = pooled_box_features(nhwc, props.to(dev), 14, aligned=False, sampling_ratio=2)
    roi = roi.clone()
    del model, nhwc
    torch.manual_seed(12)
    head = TD.DensePoseDeepLabHead(256, 512, 8, use_nonlocal=True)
    with torch.no_grad():
        head.NLBlock.W[1].weight.uniform_(0.5, 1.5)
        head.NLBlock.W[1].bias.uniform_(-0.2, 0.2)
    predictor = TD.DensePosePredictor(512)
    sel = keep_cpu.nonzero().flatten()
    tgt = {k: v[sel] for k, v in targets.items()
           if k in ("gt_segm", "gt_points01", "gt_part", "gt_u", "gt_v", "point_valid")}

    def dp_run(d, h, p, feats):
        out = h(feats)
        s, i, u, v = p(out)
        idx = sel.to(d)
        losses = TD.densepose_losses(s[idx], i[idx], u[idx], v[idx],
                                     **{k: t.to(d) for k, t in tgt.items()})
        return out, losses

    runs = {}
    for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
        h, p = copy.deepcopy(head).to(d).train(), copy.deepcopy(predictor).to(d).train()
        t0 = time.perf_counter()
        out, losses = dp_run(d, h, p, roi.to(d))
        losses["total"].backward()
        torch.cuda.synchronize()
        runs[tag] = (h, p, out.detach().cpu(), {k: v.item() for k, v in losses.items()},
                     time.perf_counter() - t0)
    (hk, pk, ok, lk, _), (hc, pc, oc, lc, cpu_s) = runs["card"], runs["cpu"]
    d_out = float((ok - oc).abs().max() / oc.abs().max())
    d_loss = max(abs(lk[k] - lc[k]) / abs(lc[k]) for k in lc)
    gates = int(((ok > 0) != (oc > 0)).sum())
    g_worst, g_name = _grad_report(list(hk.named_parameters()) + list(pk.named_parameters()),
                                   list(hc.named_parameters()) + list(pc.named_parameters()))
    lines.append(
        f"reference check, DensePose training side at R101-FPN width on {card}: the trunk at "
        f"{DET_TEST}x{DET_TEST} on {frames.shape[0]} images, {R} ROIs, {n_keep} kept by "
        f"densepose_data_filter (IoU with their own box {float(iou.min()):.3f}-"
        f"{float(iou.max()):.3f}; card and CPU filters equal), "
        f"{int(tgt['point_valid'].sum())} valid points; DeepLab head (512, 8 convs, ASPP "
        f"(6, 12, 56), NonLocal) + predictor + losses + backward, card vs CPU: head output "
        f"{d_out:.3e} of its largest (bound 1e-4), {gates} of {ok.numel()} output gates differ; "
        f"losses " + ", ".join(f"{k} {lk[k]:.6f}" for k in lk)
        + f", worst {d_loss:.3e} relative (bound 1e-5); gradients worst {g_worst:.3e} of the "
        f"tensor's largest ({g_name}; bound 1e-3; NLBlock.phi.0.bias, whose exact gradient is 0, "
        f"against phi's weight's); the CPU run {cpu_s:.1f} s")
    if d_out > 1e-4 or d_loss > 1e-5 or g_worst > 1e-3:
        raise AssertionError(lines[-1])

    # Times on the card, medians of 5 by CUDA events, float32 then bfloat16
    # autocast; the rate-56 ASPP branch alone.
    h, p = hk, pk
    sel, tgt = sel.to(dev), {k: v.to(dev) for k, v in tgt.items()}

    def fwd():
        return dp_run(dev, h, p, roi)[1]["total"]

    def fwd_bwd():
        fwd().backward()

    def med(fn, autocast):
        ts = []
        for i in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize()
            if i:
                ts.append(start.elapsed_time(end))
        return float(np.median(ts))

    torch.cuda.reset_peak_memory_stats()
    times = {(name, ac): med(fn, ac) for ac in (False, True)
             for name, fn in (("forward", lambda: fwd().item()), ("forward + backward",
                                                                  fwd_bwd))}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    branch = h.ASPP.convs[3]
    with torch.no_grad():
        rate56_ms = cuda_ms(lambda: branch(roi), 20)
    flops = deeplab_forward_flops(R)
    lines.append(
        f"times on {card}: DeepLab head + predictor + losses on {R} ROIs (14x14 x 256 in), "
        f"medians of 5 by CUDA events: float32 forward {times[('forward', False)]:.3f} ms, "
        f"forward + backward {times[('forward + backward', False)]:.3f} ms; bfloat16 autocast "
        f"forward {times[('forward', True)]:.3f} ms, forward + backward "
        f"{times[('forward + backward', True)]:.3f} ms; peak device memory {peak:.2f} GiB; "
        f"{flops / 1e12:.3f} TFLOP forward by count ({flops / 1e9 / times[('forward', False)]:.1f} "
        f"TFLOP/s float32); the rate-56 ASPP branch alone (conv + GroupNorm + ReLU, no grad) "
        f"{rate56_ms:.3f} ms")
    del runs, hk, pk, hc, pc

    # (b) PointRend.
    model = load_detector("pointrend", pkls[1], dev)
    with torch.inference_mode():
        p2 = model.trunk(x)[0][0]
        mask_roi = roi_align(p2, props.to(dev), 1.0 / 4, 14, sampling_ratio=1, mode="zeros")
    p2, mask_roi = p2.clone(), mask_roi.clone()
    coarse_in = mask_roi.reshape(R, 14, 14, -1).permute(0, 3, 1, 2).contiguous()
    coarse_head0, point_head0 = model.roi_heads.mask_coarse_head, model.roi_heads.mask_point_head
    del model
    boxes = props.view(-1, 4)
    image_index = torch.arange(props.shape[0]).repeat_interleave(props.shape[1])
    gen = torch.Generator(device=dev).manual_seed(7)
    cand, uniform = TPR.importance_sample_draws(R, 196, 3.0, 0.75, generator=gen)
    n_unc = int(0.75 * 196)

    def pr_run(d, ch, ph, chosen=None):
        coarse = ch(coarse_in.to(d))
        with torch.no_grad():
            pts = TPR.select_importance_points(coarse, cand.to(d), uniform.to(d), n_unc)
        if chosen is not None:
            pts = torch.where(chosen[:, None, None].to(d), pts, chosen_pts.to(d))
        fine = TPR.sample_fine_features(p2.to(d), boxes.to(d), pts, image_index.to(d))
        coarse_pt = TPR.sample_mask_at_points(coarse.permute(0, 2, 3, 1), pts)
        logits = ph(fine.transpose(1, 2), coarse_pt.transpose(1, 2))[:, 0]
        loss = TPR.mask_point_loss(logits, targets["gt_mask28"].to(d), pts)
        return coarse, pts, loss

    prs = {}
    for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
        ch = copy.deepcopy(coarse_head0).to(d).train().requires_grad_(True)
        ph = copy.deepcopy(point_head0).to(d).train().requires_grad_(True)
        if tag == "cpu":
            # Where a cut is within 1e-5 the CPU takes the card's points.
            with torch.no_grad():
                coarse_c = ch(coarse_in.cpu())
            unc = TPR.uncertainty(TPR.sample_mask_at_points(
                coarse_c[:, :1].permute(0, 2, 3, 1), cand.cpu())[..., 0])
            ordered = torch.sort(unc, dim=-1, descending=True).values
            gap = ordered[:, n_unc - 1] - ordered[:, n_unc]
            clear = gap > 1e-5
            chosen_pts = prs["card"][1]
            coarse, pts, loss = pr_run(d, ch, ph, chosen=clear)
        else:
            coarse, pts, loss = pr_run(d, ch, ph)
        loss.backward()
        prs[tag] = (coarse.detach().cpu(), pts.detach().cpu(), loss.item(), ch, ph)
    (ck, ptk, lk, chk, phk), (cc, ptc, lc, chc, phc) = prs["card"], prs["cpu"]

    def as_sets(p):
        key = p[:, :n_unc, 0] * 4 + p[:, :n_unc, 1]
        return torch.sort(key, dim=-1).values

    same_sets = (as_sets(ptk) == as_sets(ptc)).all(-1)
    if not bool(same_sets[clear].all()):
        raise AssertionError("importance points differ where the top-k cut clears 1e-5")
    d_coarse = float((ck - cc).abs().max() / cc.abs().max())
    d_loss = abs(lk - lc) / abs(lc)
    g_worst, g_name = _grad_report(list(chk.named_parameters()) + list(phk.named_parameters()),
                                   list(chc.named_parameters()) + list(phc.named_parameters()))
    lines.append(
        f"reference check, PointRend training side on {card}: P2 of the R50-FPN trunk at "
        f"{DET_TEST}x{DET_TEST}, coarse head at 7x7 on {R} ROIs, {196} importance points "
        f"(x3, 0.75) drawn on the card, point head, mask_point_loss against 28x28 masks, "
        f"backward; card vs CPU given the card's draws: coarse logits {d_coarse:.3e} of the "
        f"largest; the top-k cut clears 1e-5 on {int(clear.sum())} of {R} ROIs (smallest gap "
        f"{float(gap.min()):.3e}), chosen point sets equal on all of those ({int(same_sets.sum())} "
        f"in all, {int((ptk == ptc).all(-1).all(-1).sum())} in the same order); loss "
        f"{lk:.6f} vs {lc:.6f}, {d_loss:.3e} relative (bound 1e-5); gradients worst "
        f"{g_worst:.3e} of the tensor's largest ({g_name}; bound 1e-4)")
    if d_loss > 1e-5 or g_worst > 1e-4:
        raise AssertionError(lines[-1])
    def pr_step():
        pr_run(dev, chk, phk)[2].backward()
    lines.append(f"times on {card}: PointRend coarse head + importance points + point head + "
                 f"loss + backward on {R} ROIs: {cuda_ms(pr_step, 5):.3f} ms (mean of 5)")

    # (c) Converters: the seeded DeepLab head (the reference's init: the NL
    # GroupNorm at 0) through a detectron2 pickle and through a flax tree.
    torch.manual_seed(13)
    seeded = TD.DensePoseDeepLabHead(256, 512, 8, use_nonlocal=True)
    state = seeded.state_dict()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "densepose_rcnn_R_101_FPN_DL_s1x.pkl")
        save_d2_pkl(path, {DEEPLAB_PREFIX + k: v for k, v in state.items()})
        loaded = load_d2_pkl(path)
    with torch.device("meta"):
        fresh = TD.DensePoseDeepLabHead(256, 512, 8, use_nonlocal=True)
    load_detector_state(fresh, {k[len(DEEPLAB_PREFIX):]: v for k, v in loaded.items()})
    from_flax = flax_detector_to_torch_state_dict(flax_deeplab_tree(state))
    same_pkl = all(torch.equal(fresh.state_dict()[k], state[k]) for k in state)
    same_flax = (sorted(from_flax) == sorted(DEEPLAB_PREFIX + k for k in state)
                 and all(np.array_equal(from_flax[DEEPLAB_PREFIX + k], state[k].numpy())
                         for k in state))
    lines.append(f"converters: a DeepLab DensePose pickle of {len(loaded)} tensors loaded with "
                 f"strict=True, equal {same_pkl}; a flax DeepLab tree of "
                 f"{len(from_flax)} tensors through flax_detector_to_torch_state_dict, equal "
                 f"{same_flax}")
    if not (same_pkl and same_flax and len(loaded) == len(state)):
        raise AssertionError(lines[-1])
    return lines


# Phase 4l: the JAX package's orbax checkpoints, read and written without
# JAX, orbax or tensorstore.  The zstd modes orbax's level-1 frames reach in
# the committed fixture (tests/test_torch_orbax.py holds the same list).
ORBAX_FIXTURE = os.path.join("tests", "torch_orbax", "jax_ckpt_epoch3")
FIXTURE_MODES = ("frames", "raw_blocks", "rle_blocks", "compressed_blocks", "raw_literals",
                 "huffman_literals", "treeless_literals", "huffman_1_stream",
                 "huffman_4_streams", "seq_predefined", "seq_fse")


def tree_leaves(tree, prefix=""):
    """(dotted key path, leaf) of a restored tree, None leaves left out."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from tree_leaves(v, name)
        elif v is not None:
            yield name, v


def same_checkpoint(a, b):
    """Two `load_checkpoint` dicts equal, tensors bit for bit, BatchNorm's
    `num_batches_tracked` aside: the JAX tree holds no such counter (a
    directory reads as 0, the port's `.pt` counts the train steps), and
    BatchNorm never reads it (its momentum is fixed)."""
    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(b, dict):
        return set(a) == set(b) and all(same_checkpoint(a[k], b[k]) for k in b
                                        if not str(k).endswith("num_batches_tracked"))
    if isinstance(b, list):
        return len(a) == len(b) and all(same_checkpoint(x, y) for x, y in zip(a, b))
    return a == b


def state_digest(state):
    """SHA-256 of the parameters, buffers (`num_batches_tracked` aside, as
    in `same_checkpoint`), log-variances and Adam's moments."""
    h = hashlib.sha256()
    for k, t in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for t in state.log_vars.values():
        h.update(t.detach().cpu().numpy().tobytes())
    for s in state.optimizer.state_dict()["state"].values():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            h.update(s[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def orbax_checkpoints(card, train_dir, train_cfg, proxy_dir, eval_data, smpl_dir, work):
    """Phase 4l.  (a) The committed JAX-written fixture restored and held
    to its SHA-256 digests, with the zstd modes its frames reached.  (b)
    Phase 4c's trained ResNet-18 (the released configuration) written with
    `save_orbax_checkpoint`, read back bit for bit, and each entry point on
    the directory against the same entry point on the `.pt`: predict over
    phase 4b's 64 cached proxies (npy outputs equal, 2 face-id launches),
    eval on phase 4a's 64 samples (metrics equal, 4 packed launches), the
    parity gate (every row PASS), a one-epoch resume (history and state
    equal, 6 packed launches).  (c) Times.  Returns (lines, the directory
    runs' launches {packed, faceid})."""
    from straps_tpu_torch.cli import run_eval, run_parity_gate, run_predict, run_train
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.train.loop import build_training
    from straps_tpu_torch.utils import zstd
    from straps_tpu_torch.utils.checkpoints import (
        checkpoint_path, load_checkpoint, orbax_checkpoint_path, restore_checkpoint,
        save_orbax_checkpoint,
    )

    lines = []
    # (a) The fixture.
    fixture = os.path.join(HERE, ORBAX_FIXTURE)
    with open(os.path.join(HERE, "tests", "torch_orbax", "digests.json")) as f:
        want = json.load(f)
    zstd.mode_counts(reset=True)
    got = {name: {"sha256": hashlib.sha256(leaf.tobytes()).hexdigest(),
                  "dtype": leaf.dtype.str, "shape": list(leaf.shape)}
           for name, leaf in tree_leaves(restore_checkpoint(fixture))}
    counts = zstd.mode_counts()
    lines.append(f"orbax fixture: {len(got)} leaves restored, SHA-256 "
                 f"{'equal' if got == want else 'DIFFERENT'}; zstd modes met: {counts}")
    if got != want:
        raise AssertionError("the orbax fixture does not reproduce its digests")
    if not all(counts[m] > 0 for m in FIXTURE_MODES):
        raise AssertionError(f"the fixture's frames missed a zstd mode: {counts}")

    # (b) Phase 4c's trained state as the JAX package's orbax directory.
    pt = os.path.join(train_dir, checkpoint_path(train_cfg.model_save_path, 0))
    saved = load_checkpoint(pt)
    state = build_training(train_cfg, device="cpu")[2]
    state.load_state_dict(saved["state"])
    orbax_dir = os.path.join(work, "straps_model_checkpoint_epoch0")
    t0 = time.perf_counter()
    save_orbax_checkpoint(orbax_dir, state, epoch=saved["epoch"], best_epoch=saved["best_epoch"],
                          best_params=saved["best_params"],
                          best_epoch_val_metrics=saved["best_epoch_val_metrics"],
                          heatmap_mode=saved["meta"]["heatmap_mode"])
    save_s = time.perf_counter() - t0
    del state
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(orbax_dir) for f in fs)
    restore_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        restored = restore_checkpoint(orbax_dir)
        restore_s.append(time.perf_counter() - t0)
    leaf_bytes = [leaf.nbytes for _, leaf in tree_leaves(restored)]
    del restored
    back = load_checkpoint(orbax_dir, task_order=train_cfg.losses_on)
    if not same_checkpoint(back, saved):
        raise AssertionError("the orbax directory does not read back as the .pt")
    lines.append(f"orbax full width: {size} bytes written by save_orbax_checkpoint and read "
                 f"back bit for bit (every tensor of the .pt but BatchNorm's "
                 f"num_batches_tracked, which the JAX tree does not hold)")

    # Predict over the 64 cached proxies, on the directory and on the .pt.
    outs, faceid = {}, {}
    for kind, ck in (("orbax", orbax_dir), ("pt", pt)):
        outs[kind] = os.path.join(work, f"predict_{kind}")
        torch.cuda.synchronize()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            run_predict.main(["--input", proxy_dir, "--checkpoint", ck, "--out-dir", outs[kind],
                              "--device", "cuda"])
        torch.cuda.synchronize()
        faceid[kind] = CR.faceid_raster_kernel.launches
    npys = sorted(f for f in os.listdir(outs["pt"]) if f.endswith(".npy"))
    same_npy = npys and all(np.array_equal(np.load(os.path.join(outs["orbax"], f)),
                                           np.load(os.path.join(outs["pt"], f))) for f in npys)
    lines.append(f"orbax predict: {len(npys)} npy outputs over the cached proxies at 256x256 "
                 f"{'bit-identical' if same_npy else 'DIFFERENT'} to the .pt's, face-id "
                 f"launches {faceid['orbax']} (directory) and {faceid['pt']} (.pt)")
    if not same_npy or faceid["orbax"] != 2:
        raise AssertionError("predict on the orbax directory differs from the .pt's")

    # Eval on phase 4a's 64 samples.
    metrics, packed = {}, {}
    for kind, ck in (("orbax", orbax_dir), ("pt", pt)):
        torch.cuda.synchronize()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics[kind] = run_eval.main(["--dataset", eval_data, "--checkpoint", ck,
                                           "--img-wh", "256", "--batch-size", "32",
                                           "--device", "cuda"])
        torch.cuda.synchronize()
        packed[kind] = CR.packed_raster_kernel.launches
    same_metrics = metrics["orbax"] == metrics["pt"]
    lines.append(f"orbax eval: metrics {'equal' if same_metrics else 'DIFFERENT'} to the .pt's "
                 f"({metrics['orbax']}), packed launches {packed['orbax']}")
    if not same_metrics or packed["orbax"] != 4:
        raise AssertionError("eval on the orbax directory differs from the .pt's")
    eval_launches = packed["orbax"]

    # The parity gate on the directory.
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = run_parity_gate.main(["--smpl-dir", smpl_dir, "--checkpoint", orbax_dir,
                                   "--input", proxy_dir, "--out-dir",
                                   os.path.join(work, "gate"), "--device", "cuda"])
    rows = gate_rows(out.getvalue())
    lines.append(f"orbax gate: exit code {rc}, " + "; ".join(
        f"{k} {v[0]} ({v[1]})" for k, v in rows.items()))
    if rc != 0 or not rows or any(v[0] != "PASS" for v in rows.values()):
        raise AssertionError(f"the parity gate on the orbax directory:\n{out.getvalue()}")

    # A one-epoch resume from the directory and from the .pt, each in a
    # copy of phase 4c's working directory (cuDNN's deterministic
    # algorithms, so that two runs of one state can agree bit for bit).
    resumed = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("orbax", "pt"):
            d = os.path.join(work, f"resume_{kind}")
            shutil.copytree(train_dir, d)
            if kind == "orbax":
                os.remove(os.path.join(d, checkpoint_path(train_cfg.model_save_path, 0)))
                shutil.copytree(orbax_dir, os.path.join(
                    d, orbax_checkpoint_path(train_cfg.model_save_path, 0)))
            torch.cuda.synchronize()
            reset_launches()
            with contextlib.chdir(d), contextlib.redirect_stdout(io.StringIO()):
                st, _, tracker = run_train.main(["--synthetic-data", "--device", "cuda",
                                                 "num_epochs=2", "resume_from_epoch=0",
                                                 "data_parallel_devices=1"])
            torch.cuda.synchronize()
            resumed[kind] = (tracker.history, state_digest(st), st.step,
                             CR.packed_raster_kernel.launches)
            del st, tracker
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (h_o, d_o, s_o, l_o), (h_p, d_p, s_p, _) = resumed["orbax"], resumed["pt"]
    lines.append(f"orbax resume: one epoch from the directory, history "
                 f"{'equal' if h_o == h_p else 'DIFFERENT'} and state digest "
                 f"{'equal' if d_o == d_p else 'DIFFERENT'} to the resume from the .pt, step "
                 f"{s_o}, packed launches {l_o}")
    if h_o != h_p or d_o != d_p or s_o != s_p or l_o != 6:
        raise AssertionError("the resume from the orbax directory differs from the .pt's")

    # (c) Times: restore of the full-width directory, the decoder on the
    # fixture's compressed frames, the write.
    from straps_tpu_torch.utils.ocdbt import OcdbtReader
    reader = OcdbtReader(fixture)
    frames = [bytes(reader.view(k)) for k in reader.list()
              if not k.endswith(b".zarray") and bytes(reader.view(k))[:4] == b"\x28\xb5\x2f\xfd"]
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    reps = max(1, int(64e6 // decoded))
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in frames:
            zstd.decompress(f)
    zstd_s = (time.perf_counter() - t0) / reps
    # The restore over compressed frames at the same scale: a directory of
    # as many leaves, each at least its trained leaf's bytes, each chunk
    # the fixture's frames of 64 KB and more concatenated (one zstd stream
    # of several frames), written with the port's OCDBT writer.
    from straps_tpu_torch.utils.ocdbt import write_database
    big = [(f, len(zstd.decompress(f))) for f in frames]
    big = [fn for fn in big if fn[1] >= 65536]
    items, tree_meta, k = {}, {}, 0
    for i, target in enumerate(leaf_bytes):
        parts, n = [], 0
        while n < target:
            parts.append(big[k % len(big)][0])
            n += big[k % len(big)][1]
            k += 1
        name = f"leaf{i:03d}"
        tree_meta[repr((name,))] = {"key_metadata": [{"key": name, "key_type": 2}],
                                    "value_metadata": {"value_type": "np.ndarray",
                                                       "skip_deserialize": False}}
        items[f"{name}/.zarray".encode()] = json.dumps(
            {"chunks": [n], "compressor": {"id": "zstd", "level": 1},
             "dimension_separator": ".", "dtype": "|u1", "fill_value": None, "filters": None,
             "order": "C", "shape": [n], "zarr_format": 2}).encode()
        items[f"{name}/0".encode()] = b"".join(parts)
    packed_dir = os.path.join(work, "compressed_epoch0")
    write_database(packed_dir, items)
    with open(os.path.join(packed_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False}, f)
    stored = sum(len(v) for k, v in items.items() if not k.endswith(b".zarray"))
    packed_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = restore_checkpoint(packed_dir)
        packed_s.append(time.perf_counter() - t0)
    out_bytes = sum(leaf.nbytes for leaf in out.values())
    del out, items
    best = min(restore_s)
    lines.append(f"orbax times on {card}: restore_checkpoint of the {size / 1e6:.1f} MB "
                 f"full-width directory {best:.3f} s ({size / 1e6 / best:.0f} MB/s; runs "
                 f"{', '.join(f'{t:.3f}' for t in restore_s)} s); zstd decode of the fixture's "
                 f"{len(frames)} frames ({decoded} bytes out), one thread: "
                 f"{decoded / 1e6 / zstd_s:.0f} MB/s; save_orbax_checkpoint {save_s:.3f} s; "
                 f"restore_checkpoint of {len(leaf_bytes)} leaves of the fixture's compressed "
                 f"frames ({stored} bytes stored, {out_bytes} bytes out) {min(packed_s):.3f} s "
                 f"({out_bytes / 1e6 / min(packed_s):.0f} MB/s out; runs "
                 f"{', '.join(f'{t:.3f}' for t in packed_s)} s)")
    ref = {"dir": orbax_dir, "pt": pt, "predict_pt": outs["pt"], "metrics": metrics["pt"],
           "resume": (h_p, d_p, s_p)}
    return lines, {"packed": eval_launches + l_o, "faceid": faceid["orbax"]}, ref


# Phase 4n: every other layout orbax writes, rewritten from phase 4l's
# directory by the test-side writer `tests/torch_orbax/relayout.py`:
# (zarr3, OCDBT, bfloat16) of each.
RELAYOUTS = {"v2_dir": (False, False, False), "zarr3_ocdbt": (True, True, False),
             "zarr3_dir": (True, False, False), "bf16_zarr3_ocdbt": (True, True, True)}


def orbax_layouts(card, assets, ref, train_dir, train_cfg, proxy_dir, eval_data, work):
    """Phase 4n.  (a) Every committed layout fixture
    (`tests/torch_orbax/layouts/`, written by orbax: zarr v2 and zarr3,
    with and without OCDBT, a bfloat16 state, every dtype, scalars,
    strings) restored and held to its digests.  (b) Phase 4l's full-width
    directory (`ref`) rewritten into `RELAYOUTS`.  (c) On each, the
    predict CLI over the 64 cached proxies: npy outputs equal to phase
    4l's `.pt` run (bfloat16: to the `.pt` run with its parameters and
    statistics rounded to bfloat16 and flax's bfloat16-variance BatchNorm
    arithmetic), exactly 2 face-id launches, held bit for bit against the
    plain version on their inputs.  (d) The eval CLI on the zarr3
    directory and the train CLI resumed one epoch from the per-leaf one,
    equal to phase 4l's (4 and 6 packed launches).  (e) The resume from
    the bfloat16 directory refused by name.  (f) `restore_checkpoint`
    seconds and MB/s of each.  The 3D scatters of `verts_vis/` are not
    drawn here (phase 4l draws them).  Returns (lines, {packed, faceid:
    the directories' launches, errs: the face-id checks' depth errors})."""
    from straps_tpu_torch.cli import run_eval, run_predict, run_train
    from straps_tpu_torch.models import resnet
    from straps_tpu_torch.predict import pipeline as pipe
    from straps_tpu_torch.predict.pipeline import REPOSED_CAM_WP
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.utils.checkpoints import (
        load_checkpoint, orbax_checkpoint_path, restore_checkpoint,
    )
    sys.path.insert(0, os.path.join(HERE, "tests", "torch_orbax"))
    import relayout

    lines = []
    # (a) The committed fixtures.
    fixtures = os.path.join(HERE, "tests", "torch_orbax", "layouts")
    with open(os.path.join(HERE, "tests", "torch_orbax", "layouts.json")) as f:
        want = json.load(f)
    bad = [name for name in sorted(want) if relayout.leaf_digests(
        restore_checkpoint(os.path.join(fixtures, name))) != want[name]]
    lines.append(f"orbax layouts: {len(want)} committed fixtures restored, digests "
                 f"{'equal' if not bad else 'DIFFERENT: ' + ', '.join(bad)}")
    if bad or len(want) < 10:
        raise AssertionError(f"orbax layout fixtures differ from their digests: {bad}")

    # (b) Phase 4l's directory in every other layout, and (f) restore times.
    tree = restore_checkpoint(ref["dir"])
    dirs, restore_s, sizes = {}, {}, {}
    for name, (zarr3, use_ocdbt, bf16) in RELAYOUTS.items():
        dirs[name] = os.path.join(work, name, "straps_model_checkpoint_epoch0")
        written = relayout.cast_bfloat16(tree) if bf16 else tree
        relayout.write_layout(dirs[name], written, zarr3, use_ocdbt)
        sizes[name] = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(dirs[name]) for f in fs)
        restore_s[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = restore_checkpoint(dirs[name])
            restore_s[name].append(time.perf_counter() - t0)
        if relayout.leaf_digests(got) != relayout.leaf_digests(written):
            raise AssertionError(f"{name}: the rewritten directory does not read back")
    del tree, got, written
    lines.append(f"orbax layout times on {card}: restore_checkpoint " + "; ".join(
        f"{name} {sizes[name]} bytes {min(t):.3f} s ({sizes[name] / 1e6 / min(t):.0f} MB/s; "
        f"runs {', '.join(f'{x:.3f}' for x in t)} s)" for name, t in restore_s.items()))

    # (c) The predict CLI on each directory.  The bfloat16 one against the
    # `.pt` with its tensors rounded to bfloat16, every BatchNorm with
    # flax's bfloat16-variance arithmetic, as its directory loads them.
    saved = load_checkpoint(ref["pt"])

    def rounded(sd):
        return {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
                for k, v in sd.items()}
    bf16_pt = os.path.join(work, "bf16_rounded.pt")
    low_state = dict(saved["state"], model=rounded(saved["state"]["model"]))
    torch.save(dict(saved, state=low_state, best_params=rounded(saved["best_params"])), bf16_pt)
    real_vis = pipe.write_verts_vis
    pipe.write_verts_vis = lambda *a, **k: None
    outs, faceid, preds = {}, {}, {}
    try:
        runs = [(name, dirs[name]) for name in RELAYOUTS] + [("bf16_pt", bf16_pt)]
        for name, ck in runs:
            outs[name] = os.path.join(work, f"predict_{name}")
            resnet.BatchNorm2d.bfloat16_variance = "root" if name == "bf16_pt" else None
            torch.cuda.synchronize()
            reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                preds[name] = run_predict.main(["--input", proxy_dir, "--checkpoint", ck,
                                                "--out-dir", outs[name], "--device", "cuda"])
            torch.cuda.synchronize()
            faceid[name] = CR.faceid_raster_kernel.launches
    finally:
        pipe.write_verts_vis = real_vis
        resnet.BatchNorm2d.bfloat16_variance = None
    npys = sorted(f for f in os.listdir(ref["predict_pt"]) if f.endswith(".npy"))
    errs = []
    for name in RELAYOUTS:
        base = outs["bf16_pt"] if name.startswith("bf16") else ref["predict_pt"]
        same = npys and all(np.array_equal(np.load(os.path.join(outs[name], f)),
                                           np.load(os.path.join(base, f))) for f in npys)
        lines.append(f"orbax layout {name}: predict's {len(npys)} npy outputs "
                     f"{'bit-identical' if same else 'DIFFERENT'} to the "
                     f"{'bfloat16-rounded ' if name.startswith('bf16') else ''}.pt run's, "
                     f"face-id launches {faceid[name]}")
        if not same or faceid[name] != 2:
            raise AssertionError(f"{name}: predict differs from the .pt's")
        if name in ("v2_dir", "bf16_zarr3_ocdbt"):     # the others' kernel inputs: the same
            n = len(preds[name]["names"])
            errs.append(compare_faceid(
                f"{name} predict rend B={n} 256x256",
                *vis_faceid_inputs(assets, preds[name]["verts"], preds[name]["cam_wp"],
                                   256), 256, 256))
            errs.append(compare_faceid(
                f"{name} predict reposed B={n} 256x256",
                *vis_faceid_inputs(assets, preds[name]["reposed_verts"],
                                   torch.tensor(REPOSED_CAM_WP).expand(n, 3), 256,
                                   rotate_x180=True), 256, 256))

    # (d) Eval on the zarr3 directory, one-epoch resume from the per-leaf one.
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = run_eval.main(["--dataset", eval_data, "--checkpoint", dirs["zarr3_dir"],
                                 "--img-wh", "256", "--batch-size", "32", "--device", "cuda"])
    torch.cuda.synchronize()
    eval_launches = CR.packed_raster_kernel.launches
    lines.append(f"orbax layout zarr3_dir: eval metrics "
                 f"{'equal' if metrics == ref['metrics'] else 'DIFFERENT'} to phase 4l's, "
                 f"packed launches {eval_launches}")
    if metrics != ref["metrics"] or eval_launches != 4:
        raise AssertionError("eval on the zarr3 directory differs from phase 4l's")
    d = os.path.join(work, "resume_v2_dir")
    shutil.copytree(train_dir, d, ignore=shutil.ignore_patterns("*.pt"))
    shutil.copytree(dirs["v2_dir"], os.path.join(d, orbax_checkpoint_path(
        train_cfg.model_save_path, 0)))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        reset_launches()
        with contextlib.chdir(d), contextlib.redirect_stdout(io.StringIO()):
            st, _, tracker = run_train.main(["--synthetic-data", "--device", "cuda",
                                             "num_epochs=2", "resume_from_epoch=0",
                                             "data_parallel_devices=1"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    resume_launches = CR.packed_raster_kernel.launches
    got = (tracker.history, state_digest(st), st.step)
    del st, tracker
    lines.append(f"orbax layout v2_dir: one-epoch resume, history and state "
                 f"{'equal' if got == ref['resume'] else 'DIFFERENT'} to phase 4l's, step "
                 f"{got[2]}, packed launches {resume_launches}")
    if got != ref["resume"] or resume_launches != 6:
        raise AssertionError("the resume from the per-leaf directory differs from phase 4l's")

    # (e) The resume from the bfloat16 directory, refused by name.
    d = os.path.join(work, "resume_bf16")
    shutil.copytree(train_dir, d, ignore=shutil.ignore_patterns("*.pt"))
    shutil.copytree(dirs["bf16_zarr3_ocdbt"], os.path.join(d, orbax_checkpoint_path(
        train_cfg.model_save_path, 0)))
    try:
        with contextlib.chdir(d), contextlib.redirect_stdout(io.StringIO()):
            run_train.main(["--synthetic-data", "--device", "cuda", "num_epochs=2",
                            "resume_from_epoch=0", "data_parallel_devices=1"])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    lines.append(f"orbax layout bf16_zarr3_ocdbt: resume refused: {refusal}")
    if not refusal or "bfloat16 training state is not supported" not in refusal:
        raise AssertionError("the resume from a bfloat16 state was not refused by name")
    return lines, {"packed": eval_launches + resume_launches,
                   "faceid": sum(faceid[name] for name in RELAYOUTS), "errs": errs}


# Phase 4o: the port as `pip install .` installs it.  The child process
# loads this file by path (not as `__main__`) from a directory that holds
# only the installed files.
def installed_copy_child(site, spec_json):
    """Phase 4o's child: in a process whose `sys.path` starts with `site`
    (the installed files), resolve every surface, build every kernel and
    host library from the copy's `csrc/`, run the eval and predict CLIs at
    full width with each kernel launch recorded, and hold each launch bit
    for bit against its plain version.  Prints one `installed-copy:` JSON
    line; raises on any fault."""
    import importlib

    spec = json.loads(spec_json)
    t_child = time.perf_counter()
    import straps_tpu_torch
    pkg = os.path.dirname(os.path.abspath(straps_tpu_torch.__file__))
    if pkg != os.path.join(site, "straps_tpu_torch"):
        raise AssertionError(f"straps_tpu_torch imported from {pkg}, not from {site}")
    names = 0
    for sub in SURFACES:
        module = importlib.import_module(f"straps_tpu_torch.{sub}")
        for name in module.__all__:
            getattr(module, name)
        for counterpart in module.JAX_COUNTERPARTS.values():
            if not isinstance(counterpart, str):
                for name in counterpart:
                    getattr(module, name)
        names += len(module.JAX_COUNTERPARTS)
    from straps_tpu_torch.cli import run_eval, run_predict
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.utils import native_build

    def timed(build, arg):
        t = time.perf_counter()
        path = build(arg)
        return path, time.perf_counter() - t

    sources = [k.source for k in native_build.KERNEL_LIBRARIES]
    with ThreadPoolExecutor(len(sources) + len(HOST_SOURCES)) as pool:
        jobs = ([pool.submit(timed, native_build.cuda_library, src) for src in sources]
                + [pool.submit(timed, native_build.cxx_library,
                               os.path.join(native_build.CSRC_DIR, f"{h}.cpp"))
                   for h in HOST_SOURCES])
        builds = [job.result() for job in jobs]
    build_dir = os.path.join(pkg, "_build")
    for path, _ in builds:
        if os.path.dirname(path) != build_dir:
            raise AssertionError(f"{path} was not built into the copy's {build_dir}")
    for src in sources:
        if not src.startswith(pkg):
            raise AssertionError(f"a kernel builds from {src}, outside the copy")
    for kernel in native_build.KERNEL_LIBRARIES:
        kernel.library()

    raster = (CR.packed_raster_kernel, CR.faceid_raster_kernel)
    recorded = []
    for kernel in raster:
        cls = type(kernel)

        def record(self, *args, _call=cls.__call__):
            out = _call(self, *args)
            recorded.append((self.name, [a.clone() if torch.is_tensor(a) else a for a in args],
                             [t.clone() for t in (out if isinstance(out, tuple) else (out,))]))
            return out
        cls.__call__ = record

    def cli(main, argv):
        native_build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            result = main(argv)
        torch.cuda.synchronize()
        return result, {k.name: k.launches for k in raster}

    t0 = time.perf_counter()
    metrics, eval_launches = cli(run_eval.main, [
        "--dataset", spec["data"], "--checkpoint", spec["ckpt"], "--img-wh", "256",
        "--batch-size", str(spec["batch"]), "--device", "cuda"])
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, predict_launches = cli(run_predict.main, [
        "--input", spec["proxy_dir"], "--checkpoint", spec["ckpt_pred"], "--out-dir",
        spec["out_dir"], "--device", "cuda"])
    predict_s = time.perf_counter() - t0

    checks = []
    for name, args, out in recorded:
        if name == "raster_packed":
            want = (CR.rasterize_packed_reference(*args),)
        else:
            want = CR.rasterize_faceid_reference(*args)
        checks.append({"kernel": name, "B": int(args[0].shape[0]),
                       "identical": all(torch.equal(a, b) for a, b in zip(out, want))})
    print("installed-copy: " + json.dumps({
        "package": pkg, "names": names, "metrics": metrics,
        "builds": {os.path.basename(path): secs for path, secs in builds},
        "eval_launches": eval_launches, "predict_launches": predict_launches,
        "eval_s": eval_s, "predict_s": predict_s, "checks": checks,
        "child_s": time.perf_counter() - t_child}))


def installed_copy(card, spec, want_metrics, want_out_dir):
    """Phase 4o: copy the installed files outside the repository, run
    `installed_copy_child` on them in a fresh process, and hold its
    outputs to the evaluation and predict slices'.  Returns (lines,
    {kernel: launches})."""
    from straps_tpu_torch.utils.package_copy import copy_package

    site = tempfile.mkdtemp(prefix="straps_installed_")
    work = tempfile.mkdtemp(prefix="straps_installed_cwd_")
    try:
        files = copy_package(HERE, site)
        spec = dict(spec, out_dir=os.path.join(work, "predict"))
        code = ("import importlib.util, sys\n"
                f"sys.path.insert(0, {site!r})\n"
                f"spec = importlib.util.spec_from_file_location('chip_smoke_installed', "
                f"{os.path.abspath(__file__)!r})\n"
                "module = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(module)\n"
                f"module.installed_copy_child({site!r}, {json.dumps(spec)!r})\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the installed copy's process failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
        (line,) = [x for x in proc.stdout.splitlines() if x.startswith("installed-copy: ")]
        got = json.loads(line[len("installed-copy: "):])
        npys = sorted(f for f in os.listdir(want_out_dir) if f.endswith(".npy"))
        same_npy = len(npys) == 4 * spec["n"] and all(
            np.array_equal(np.load(os.path.join(want_out_dir, f)),
                           np.load(os.path.join(spec["out_dir"], f))) for f in npys)
    finally:
        shutil.rmtree(site, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    csrc = sorted(f for f in files if "/csrc/" in f)
    kernels = {name: got["eval_launches"][name] + got["predict_launches"][name]
               for name in got["eval_launches"]}
    identical = [c for c in got["checks"] if c["identical"]]
    lines = [
        f"installed copy: {len(files)} files ({len(csrc)} in csrc/: "
        f"{', '.join(os.path.basename(f) for f in csrc)}), the port imported from "
        f"{got['package']}, {got['names']} JAX names resolved through the surfaces",
        f"installed copy: builds into the copy's _build/ on {card}, each timed in parallel: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in got["builds"].items()),
        f"installed copy: eval of {spec['n']} samples {got['eval_s']:.3f} s, metrics "
        f"{'equal' if got['metrics'] == want_metrics else 'DIFFERENT'} to the evaluation "
        f"slice's, launches {got['eval_launches']}; predict of {spec['n']} cached proxies "
        f"{got['predict_s']:.3f} s, npy outputs {'bit-identical' if same_npy else 'DIFFERENT'} "
        f"to the predict slice's, launches {got['predict_launches']}; "
        f"{len(identical)} of {len(got['checks'])} launches bit-identical to their plain "
        f"versions ({[(c['kernel'], c['B']) for c in got['checks']]}); child process "
        f"{got['child_s']:.1f} s of {wall:.1f} s wall"]
    if got["metrics"] != want_metrics or not same_npy:
        raise AssertionError("the installed copy's eval or predict differs from the slices'")
    if (got["eval_launches"] != {"raster_packed": 4, "raster_faceid": 0}
            or got["predict_launches"] != {"raster_packed": 0, "raster_faceid": 2}
            or len(got["checks"]) != 6 or len(identical) != 6):
        raise AssertionError(f"the installed copy's launches: eval {got['eval_launches']}, "
                             f"predict {got['predict_launches']}, checks {got['checks']}")
    if len(csrc) != 9 or any("_build" in f.split("/") for f in files):
        raise AssertionError(f"the installed copy's csrc/: {csrc}")
    return lines, kernels


def deeplab_forward_flops(R, cin=256, dim=512, convs=8, side=14):
    """Multiply-adds x 2 of the DeepLab head + predictor forward on R ROIs:
    ASPP's 1x1, three 3x3 and pooled branches and its projection, the
    NonLocal block's projections and products, the stacked 3x3 convs, and
    the predictor's four 4x4 stride-2 deconvolutions (15 + 3 x 25 channels)."""
    hw = side * side
    inter = cin // 2
    aspp = hw * cin * cin * (1 + 3 * 9) + cin * cin + hw * 5 * cin * cin
    nonlocal_ = 3 * hw * cin * inter + 2 * hw * (hw // 4) * inter + hw * inter * cin
    stacked = hw * 9 * dim * (cin + (convs - 1) * dim)
    predictor = hw * dim * (15 + 75) * 16
    return 2.0 * R * (aspp + nonlocal_ + stacked + predictor)


def main() -> int:
    t_main = time.perf_counter()
    # 1. Device.
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import straps_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(straps_tpu_torch.__file__))) != HERE:
        raise RuntimeError("chip_smoke.py must run from a checkout holding straps_tpu_torch/")
    from straps_tpu_torch.cli import run_eval, run_predict, run_train
    from straps_tpu_torch.config import PredictConfig, TrainConfig
    from straps_tpu_torch.eval_harness.datasets import load_eval_dataset
    from straps_tpu_torch.eval_harness.runner import run_evaluation, synthesise_proxy_inputs
    from straps_tpu_torch.predict.pipeline import (
        REPOSED_CAM_WP, load_regressor_variables, make_predict_fn, predict_3d, save_proxies,
    )
    from straps_tpu_torch.render import cuda_raster as CR
    from straps_tpu_torch.render import raster as R
    from straps_tpu_torch.losses.multi_task import init_loss_log_vars
    from straps_tpu_torch.parallel import launch
    from straps_tpu_torch.smpl.assets import load_synthetic_assets
    from straps_tpu_torch.train.loop import build_training, pull_to_host
    from straps_tpu_torch.train.step import train_on_batch
    from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
    from straps_tpu_torch.render.soft_silhouette import soft_silhouette_from_wp
    from straps_tpu_torch.utils.checkpoints import checkpoint_path, load_checkpoint
    from straps_tpu_torch.utils.device import resolve_device
    from straps_tpu_torch.utils.model_utils import count_parameters
    from straps_tpu_torch.utils.profiling import TRACE_FILE
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from raster_scenes import KERNEL_SCENES

    dev = resolve_device("cuda")

    # 2. Build: one nvcc per kernel source and one g++ per host C++ source
    # (the JPEG decoder, the npy reader, the zstd decoder), all started
    # together.
    from straps_tpu_torch.utils import native_build
    t0 = time.perf_counter()
    from straps_tpu_torch.models import batchnorm as BN
    sources = [k.source for k in native_build.KERNEL_LIBRARIES]
    with ThreadPoolExecutor(len(sources) + len(HOST_SOURCES)) as pool:
        host = [pool.submit(native_build.cxx_library,
                            os.path.join(native_build.CSRC_DIR, f"{h}.cpp"))
                for h in HOST_SOURCES]
        libs = list(pool.map(native_build.cuda_library, sources))
        host_libs = [h.result() for h in host]
    for kernel in native_build.KERNEL_LIBRARIES:
        kernel.library()
    print(f"build: {', '.join(libs + host_libs)} in {time.perf_counter() - t0:.2f} s")
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
    # The BatchNorm kernels at ResNet-50's training shapes.
    batchnorm_entry = batchnorm_kernel_entry(card)

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

    # 4c. The training slice: the train CLI for one epoch at the released
    # configuration, in a working directory of its own.
    train_cfg = TrainConfig()
    B = train_cfg.batch_size
    train_dir = os.path.join(tmp.name, "train")
    os.makedirs(train_dir)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(train_dir), contextlib.redirect_stdout(io.StringIO()) as cli_out:
        state, _, tracker = run_train.main(["--synthetic-data", "--device", "cuda",
                                            "num_epochs=1", "data_parallel_devices=1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = CR.packed_raster_kernel.launches
    train_bn_launches = BN.batchnorm_kernels.launches
    train_steps, val_steps = 4, 2         # 560 and 280 corpus samples at batch 140
    print("\n".join(line for line in cli_out.getvalue().splitlines()
                    if line.startswith(("epoch ", "Training completed"))))
    print(f"slice: train CLI, 1 epoch at batch {B}, {train_cfg.img_wh}x{train_cfg.img_wh}, "
          f"bf16 encoder ({train_steps} train + {val_steps} val steps, first steps "
          f"included): {train_s:.3f} s wall, packed kernel launches {train_launches}, "
          f"face-id kernel launches {CR.faceid_raster_kernel.launches}, BatchNorm kernel "
          f"launches {train_bn_launches}")
    if train_launches != train_steps + val_steps:
        raise AssertionError(f"training renders: {train_launches} packed launches, want "
                             f"{train_steps + val_steps}")
    check_batchnorm_launches("ResNet-18 training", train_bn_launches, 18, train_steps)
    history = {k: v for k, v in tracker.history.items() if v}
    if not history or not all(np.isfinite(v).all() for v in history.values()):
        raise AssertionError(f"non-finite training history: {tracker.history}")
    ckpt_path = os.path.join(train_dir, checkpoint_path(train_cfg.model_save_path, 0))
    saved = load_checkpoint(ckpt_path)            # torch.load(weights_only=True)
    if (saved["epoch"] != 0 or saved["state"]["step"] != train_steps
            or saved["meta"] != {"heatmap_mode": train_cfg.heatmap_mode}
            or set(saved["best_params"]) != set(dict(state.model.named_parameters()))):
        raise AssertionError(f"checkpoint {ckpt_path}: unexpected contents")
    init_lv = init_loss_log_vars(train_cfg.losses_on, train_cfg.init_loss_weights)
    lv_moved = {k: float(state.log_vars[k].detach()) - float(init_lv[k].detach())
                for k in train_cfg.losses_on}
    print(f"slice: checkpoint {os.path.basename(ckpt_path)} read back with weights_only=True "
          f"({os.path.getsize(ckpt_path)} bytes); log-variances moved by {lv_moved}")
    if not all(abs(d) > 0 for d in lv_moved.values()):
        raise AssertionError("a loss log-variance did not move")
    del state, tracker, saved

    # The packed kernel against its plain version on the inputs of the
    # CLI's first train launch: its corpus, batch and draws.
    corpus = os.path.join(train_dir, os.path.dirname(train_cfg.log_path),
                          "synthetic_train.npz")
    flat_t, bounds_t, attr_t = training_kernel_inputs(assets, train_cfg, corpus)
    errs.append(compare_kernel(f"first train batch B={B} 256x256 culled, jittered cameras, "
                               f"vertex noise", flat_t, bounds_t, attr_t, 256, 256))
    max_abs_err = max(errs)

    # One train step, small and float32, on the card and on the CPU.  A
    # gradient is discontinuous at a ReLU's kink: a pre-activation within
    # the two devices' rounding of 0 can open its gate on one side only,
    # and the step's gradients then differ by that unit's share whatever
    # the port does.  The seed's smallest IEF pre-activation is 7e-5, and
    # the check first shows that no IEF gate differs.
    check_train_step_card_vs_cpu("one train step 64x64 B=8 f32")

    # 4d. The image slice: the predict CLI from 16 PNG images through
    # Keypoint-RCNN + PointRend R50-FPN at full width (512 frame, 800²
    # detectors, 512 proposals, 8 detections, 5 subdivision steps).
    from straps_tpu_torch.perception import ops as det_ops
    from straps_tpu_torch.predict import pipeline as pipe
    img_dir = os.path.join(tmp.name, "images")
    img_names = write_detector_pngs(assets, img_dir)
    pkls = write_detector_pkls(tmp.name)
    img_out = os.path.join(tmp.name, "predict_images")
    image_argv = ["--input", img_dir, "--silh-from", "pointrend", "--keypoint-checkpoint",
                  pkls[0], "--silhouette-checkpoint", pkls[1], "--checkpoint", ckpt_pred,
                  "--device", "cuda"]
    syncs0 = dict(det_ops.NMS_STATS)
    reset_launches()
    pred_img, image_s, stage_s, det_outs = run_image_predict(
        pipe, run_predict, image_argv + ["--out-dir", img_out])
    image_launches = CR.faceid_raster_kernel.launches
    n_img = len(img_names)
    print(f"slice: predict of {n_img} PNG images (8 at 640x480, 8 at 1024x768) through "
          f"Keypoint-RCNN + PointRend R50-FPN at {DET_TEST}x{DET_TEST}, frame {DET_FRAME}, "
          f"regressor at 256x256, renders included, first run: {image_s:.3f} s wall "
          f"({n_img / image_s:.2f} images/s), face-id kernel launches {image_launches} "
          f"(rend 1 + reposed 1), packed kernel launches {CR.packed_raster_kernel.launches}, "
          f"NMS host synchronisations "
          f"{det_ops.NMS_STATS['syncs'] - syncs0['syncs']}; of the wall: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items())
          + f", the rest (assets, selection, proxies, regressor forward, npy writes) "
          f"{image_s - sum(stage_s.values()):.3f} s")
    if image_launches != 2:
        raise AssertionError(f"image predict renders: {image_launches} face-id launches, want 2")
    check_image_predict("PointRend", pred_img, img_out, det_outs, assets, ckpt_pred, run_predict,
                        faceid_errs)

    # Both detectors on the card and on the CPU, on 2 of the images, with
    # their stages between the RPN outputs and the boxes.
    frames = pipe.read_images(img_dir, DET_FRAME, "cpu")[1][[0, 8]]       # one of each size
    for kind, pkl in zip(("keypoint", "pointrend"), pkls):
        print(detector_card_vs_cpu(kind, pkl, frames))

    # 4e. The DensePose route: the predict CLI from the same 16 PNG images
    # through Keypoint-RCNN R50-FPN + DensePose-RCNN R101-FPN at full width
    # (800² detectors, 512 proposals, 8 detections, the DensePose head at
    # 14² x 512 and S/I/U/V at 56², the 512 frame).
    dp_out = os.path.join(tmp.name, "predict_densepose")
    dp_argv = ["--input", img_dir, "--silh-from", "densepose", "--keypoint-checkpoint", pkls[0],
               "--silhouette-checkpoint", pkls[2], "--checkpoint", ckpt_pred, "--device", "cuda"]
    syncs0 = dict(det_ops.NMS_STATS)
    reset_launches()
    pred_dp, dp_s, stage_s, det_outs = run_image_predict(pipe, run_predict,
                                                         dp_argv + ["--out-dir", dp_out])
    dp_launches = CR.faceid_raster_kernel.launches
    print(f"slice: predict of {n_img} PNG images through Keypoint-RCNN R50-FPN + DensePose-RCNN "
          f"R101-FPN at {DET_TEST}x{DET_TEST}, frame {DET_FRAME}, regressor at 256x256, renders "
          f"included, first run: {dp_s:.3f} s wall ({n_img / dp_s:.2f} images/s), face-id "
          f"kernel launches {dp_launches} (rend 1 + reposed 1), packed kernel launches "
          f"{CR.packed_raster_kernel.launches}, NMS host synchronisations "
          f"{det_ops.NMS_STATS['syncs'] - syncs0['syncs']}; of the wall: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items())
          + f", the rest {dp_s - sum(stage_s.values()):.3f} s")
    if dp_launches != 2:
        raise AssertionError(f"DensePose predict renders: {dp_launches} face-id launches, want 2")
    if "part_map" not in det_outs[1]:
        raise AssertionError("the DensePose overlay was not built from the frame part maps")
    check_image_predict("DensePose", pred_dp, dp_out, det_outs, assets, ckpt_pred, run_predict,
                        faceid_errs)
    print(detector_card_vs_cpu("densepose", pkls[2], frames))

    # 4f. Evaluation on an SSP-3D release layout (labels.npz + silhouette
    # PNGs of 64 synthetic bodies at 512²) at 256², batch 32, in the image
    # frame and in the crop frame.
    ssp3d = os.path.join(tmp.name, "ssp_3d")
    write_ssp3d_layout(ssp3d, assets, n, seed=3)
    release = {}
    for frame in ("image", "crop"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            release[frame] = run_eval.main(["--dataset", ssp3d, "--checkpoint", ckpt, "--img-wh",
                                            "256", "--batch-size", str(batch), "--iou-frame",
                                            frame, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frame_launches = CR.packed_raster_kernel.launches
        if frame == "image":
            release_launches = frame_launches
        print(f"slice: eval of the {n}-sample SSP-3D release layout (512x512 silhouettes) at "
              f"256x256, batch {batch}, --iou-frame {frame}, first run: {wall:.3f} s wall "
              f"({n / wall:.2f} samples/s), packed kernel launches {frame_launches} (one per "
              f"batch), silhouette IoU {release[frame]['silhouette_ious']:.4f}, pves "
              f"{release[frame]['pves']:.4f}")
        if not all(np.isfinite(v) for v in release[frame].values()):
            raise AssertionError(f"non-finite release-layout metrics: {release[frame]}")
        if frame_launches != n // batch:
            raise AssertionError(f"release-layout eval: {frame_launches} packed launches, want "
                                 f"{n // batch}")
    if not release["image"]["silhouette_ious"] > 0.2:
        raise AssertionError(f"image-frame IoU {release['image']['silhouette_ious']} <= 0.2")

    # 4g. Training at ResNet-50 with the silhouette task: the train CLI for
    # one epoch at the released configuration otherwise (batch 140,
    # 256x256, bfloat16 encoder: 4 train + 2 val steps) with the task's
    # soft silhouettes at 64x64, under the profiler.
    r50_cfg = TrainConfig(losses_on=SIL_TASKS, init_loss_weights=dict(SIL_WEIGHTS))
    r50_cfg.model.resnet_layers = 50
    r50_argv = ["model.resnet_layers=50", f"losses_on={SIL_TASKS!r}",
                f"init_loss_weights={SIL_WEIGHTS!r}"]
    r50_dir = os.path.join(tmp.name, "train_r50")
    prof_dir = os.path.join(r50_dir, "profile")
    os.makedirs(r50_dir)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.chdir(r50_dir), contextlib.redirect_stdout(io.StringIO()) as cli_out:
        state, _, tracker = run_train.main(["--synthetic-data", "--device", "cuda",
                                            "--profile-dir", prof_dir, "num_epochs=1",
                                            "data_parallel_devices=1"]
                                           + r50_argv)
    torch.cuda.synchronize()
    r50_train_s = time.perf_counter() - t0
    r50_launches = CR.packed_raster_kernel.launches
    r50_bn_launches = BN.batchnorm_kernels.launches
    r50_cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lines = cli_out.getvalue().splitlines()
    print("\n".join(line for line in lines
                    if line.startswith(("regressor parameters", "epoch ", "Training completed"))))
    n_params = count_parameters(state.model)
    print(f"slice: train CLI at ResNet-50 with the silhouette task (64x64), 1 epoch at batch "
          f"{B}, 256x256, bf16 encoder, under the profiler ({train_steps} train + {val_steps} "
          f"val steps, first steps and the trace export included): {r50_train_s:.3f} s wall, "
          f"packed kernel launches {r50_launches}, BatchNorm kernel launches "
          f"{r50_bn_launches}, peak device memory {r50_cli_peak:.2f} GiB, {n_params} "
          f"parameters")
    if f"regressor parameters: {n_params} (ResNet-50 + IEF)" not in lines:
        raise AssertionError("the train CLI did not print the regressor's parameter count")
    if r50_launches != train_steps + val_steps:
        raise AssertionError(f"ResNet-50 training renders: {r50_launches} packed launches, "
                             f"want {train_steps + val_steps}")
    check_batchnorm_launches("ResNet-50 training", r50_bn_launches, 50, train_steps)
    history = {k: v for k, v in tracker.history.items() if v}
    if (not history["train_silhouette_losses"]
            or not all(np.isfinite(v).all() for v in history.values())):
        raise AssertionError(f"ResNet-50 training history: {tracker.history}")
    init_lv = init_loss_log_vars(SIL_TASKS, SIL_WEIGHTS)
    sil_moved = (float(state.log_vars["silhouette"].detach())
                 - float(init_lv["silhouette"].detach()))
    r50_ckpt = os.path.join(r50_dir, checkpoint_path(r50_cfg.model_save_path, 0))
    saved = load_checkpoint(r50_ckpt)             # torch.load(weights_only=True)
    if ("image_encoder.layer1.0.conv3.weight" not in saved["state"]["model"]
            or saved["state"]["step"] != train_steps or sil_moved == 0.0):
        raise AssertionError(f"ResNet-50 checkpoint {r50_ckpt}: unexpected contents, or the "
                             f"silhouette log-variance did not move ({sil_moved})")
    trace_path = os.path.join(prof_dir, TRACE_FILE)
    with open(trace_path) as f:
        trace_events = json.load(f)["traceEvents"]
    packed_names = sorted({e["name"] for e in trace_events
                           if "span_raster_kernel" in e.get("name", "")
                           and "PackedKeys" in e["name"]})
    packed_in_trace = sum(1 for e in trace_events if e.get("name") in packed_names
                          and e.get("cat") == "kernel")
    print(f"slice: ResNet-50 checkpoint read back with weights_only=True "
          f"({os.path.getsize(r50_ckpt)} bytes); silhouette log-variance moved by "
          f"{sil_moved:.3e}; trace {os.path.getsize(trace_path)} bytes, {len(trace_events)} "
          f"events, packed kernel launches in it {packed_in_trace} ({packed_names})")
    if not packed_names or packed_in_trace != r50_launches:
        raise AssertionError(f"the trace in {prof_dir} does not show the packed kernel's "
                             f"{r50_launches} launches")
    del state, tracker, saved, trace_events

    # Predict over the 64 cached proxies with the ResNet-50 checkpoint.
    r50_out = os.path.join(tmp.name, "predict_r50")
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        pred_r50 = run_predict.main(["--input", proxy_dir, "--checkpoint", r50_ckpt,
                                     "--resnet-layers", "50", "--out-dir", r50_out,
                                     "--device", "cuda"])
    r50_predict_launches = CR.faceid_raster_kernel.launches
    print(f"slice: predict of {n} cached proxies with the ResNet-50 checkpoint: face-id kernel "
          f"launches {r50_predict_launches}")
    if r50_predict_launches != 2:
        raise AssertionError(f"ResNet-50 predict: {r50_predict_launches} face-id launches, "
                             f"want 2")
    for key in ("verts", "shape", "pose_rotmats", "cam_wp"):
        if not np.isfinite(np.asarray(pred_r50[key])).all():
            raise AssertionError(f"ResNet-50 predict: non-finite {key}")

    # One ResNet-50 train step with the silhouette task, small and float32,
    # on the card and on the CPU.  The seed's smallest IEF pre-activation
    # is 8.7e-5 (the CPU's; seeds 0-11 range from 3e-7 to 8.7e-5).  Of the
    # encoder's 6.4 million selections a few flip between the devices (10
    # on an H100 80GB HBM3 at 700 W, moving a `bn3.bias` gradient by 21.6%
    # of its largest): the gradients are held against the CPU step that
    # replays the card's selections.
    check_train_step_card_vs_cpu("one ResNet-50 train step with the silhouette task 64x64 "
                                 "B=8 f32", seed=8, resnet_layers=50, silhouette=True)

    # 4h. Data parallelism on the card.  (a) A spawned rank in an NCCL group
    # of one: one float32 train step at 64x64, B=8 through the mesh path,
    # against the single-process path here from the same state and draws;
    # (c) in the same rank, the evaluation at 256x256, batch 32, over the
    # mesh against the plain run here, bit for bit (gathering over one rank
    # is the identity).
    rng = np.random.RandomState(4)
    ddp_data = {"poses": (rng.randn(n, 72) * 0.2).astype(np.float32),
                "shapes": (rng.randn(n, 10) * 0.5).astype(np.float32)}
    single_step = train_step_on("cuda")
    plain_eval = run_evaluation(ddp_data, PredictConfig(checkpoint=ckpt), batch_size=batch,
                                device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (nccl_step, nccl_step_launches, nccl_eval, nccl_eval_launches), = launch(
        ddp_nccl_checks, 1, "cuda", args=(ckpt, ddp_data, batch), timeout_s=600)
    print(f"slice: NCCL group of one on the card: a train step at 64x64, B=8 and the eval of "
          f"{n} samples at 256x256, batch {batch}, in {time.perf_counter() - t0:.3f} s wall "
          f"(process start included); packed kernel launches {nccl_step_launches} (step) + "
          f"{nccl_eval_launches} (eval)")
    check_mesh_step("a train step through the NCCL mesh of one vs the single-process step, "
                    "64x64 B=8 f32", nccl_step, single_step)
    if nccl_step_launches != 1 or nccl_eval_launches != 2 * n // batch:
        raise AssertionError(f"NCCL rank: {nccl_step_launches} + {nccl_eval_launches} packed "
                             f"launches, want 1 + {2 * n // batch}")
    eval_diff = {k: nccl_eval[k] - v for k, v in plain_eval.items() if nccl_eval[k] != v}
    print(f"reference check, eval over the NCCL mesh of one vs the plain eval: metrics that "
          f"differ {eval_diff} (bound: none), IoU {plain_eval['silhouette_ious']:.4f}")
    if eval_diff or set(nccl_eval) != set(plain_eval):
        raise AssertionError("the eval over the NCCL mesh of one differs from the plain eval")

    # (b) Two gloo ranks, both on cuda:0: the same step over the mesh of two
    # (four rows a rank) against (a)'s step; the replicas bitwise alike.
    t0 = time.perf_counter()
    gloo = launch(ddp_gloo_step, 2, "cuda:0", timeout_s=600)
    gloo_launches = [r[1] for r in gloo]
    print(f"slice: two gloo ranks on cuda:0, a train step at 64x64, B=8 (4 rows a rank): "
          f"{time.perf_counter() - t0:.3f} s wall (process starts included), packed kernel "
          f"launches {gloo_launches}, state digests {[r[0][6][:12] for r in gloo]}")
    check_mesh_step("a train step over two gloo ranks vs the NCCL mesh of one, 64x64 B=8 f32 "
                    "(each rank's IEF gates cover its rows, so they are not compared)",
                    gloo[0][0], nccl_step, gates=False)
    if gloo_launches != [1, 1] or gloo[0][0][6] != gloo[1][0][6]:
        raise AssertionError("gloo ranks: a rank's packed launches are not 1, or the replicas "
                             "differ after the step")
    ddp_launches = nccl_step_launches + nccl_eval_launches + sum(gloo_launches)

    # (d) More ranks than cards: the train CLI exits non-zero with the
    # message, before it writes a file.
    refuse_dir = os.path.join(tmp.name, "refuse")
    os.makedirs(refuse_dir)
    ranks = torch.cuda.device_count() + 1
    refused = subprocess.run(
        [sys.executable, "-m", "straps_tpu_torch.cli.run_train", "--synthetic-data",
         f"data_parallel_devices={ranks}"], cwd=refuse_dir, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=HERE), timeout=300)
    message = refused.stderr.strip().splitlines()[-1] if refused.stderr.strip() else ""
    print(f"slice: run_train data_parallel_devices={ranks} on {torch.cuda.device_count()} "
          f"card(s): exit code {refused.returncode}, files written {os.listdir(refuse_dir)}, "
          f"{message!r}")
    if (refused.returncode == 0 or os.listdir(refuse_dir)
            or f"requested a {ranks}-device mesh but only" not in message):
        raise AssertionError("run_train with more ranks than cards did not refuse")

    # 4i. JPEG photos and the whole vis output.  (a) The cv2-written
    # fixtures of tests/torch_jpeg decoded here, against the SHA-256 of
    # cv2.imread's pixels committed beside them (phase 4m holds the rest).
    from straps_tpu_torch.data import native_io
    from straps_tpu_torch.render import figures
    from straps_tpu_torch.utils.image import cv2_resize_linear_u8
    from straps_tpu_torch.utils.jpeg import decode_jpeg
    from torch_jpeg.write_codings import CODINGS
    jpeg_dir = os.path.join(HERE, "tests", "torch_jpeg")
    with open(os.path.join(jpeg_dir, "expected.json")) as f:
        jpeg_expected = {k: v for k, v in json.load(f).items() if k not in CODINGS}
    for name, want in sorted(jpeg_expected.items()):
        px = decode_jpeg(os.path.join(jpeg_dir, name))
        digest = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
        same = list(px.shape) == want["shape"] and digest == want["sha256"]
        print(f"jpeg: {name} {px.shape[1]}x{px.shape[0]} sha256 {digest[:16]} (cv2.imread "
              f"{want['sha256'][:16]}): equal {same}")
        if not same:
            raise AssertionError(f"{name}: decoded pixels differ from cv2.imread's")

    # (b) The predict CLI over phase 4d's 16 PNGs and the fixture JPEGs
    # through PointRend at full width: detections, finite outputs, exactly 2
    # face-id launches held bit for bit, the cached rerun identical, a
    # 640x480 verts_vis figure and joint-index text for every image.
    mixed_dir = os.path.join(tmp.name, "mixed")
    os.makedirs(mixed_dir)
    # The predict reads the cv2-written fixtures; the small CMYK one is held
    # to its hash above.
    mixed_jpegs = [f for f in jpeg_expected if not f.startswith("cmyk")]
    for d, files in ((img_dir, os.listdir(img_dir)), (jpeg_dir, mixed_jpegs)):
        for f in files:
            os.symlink(os.path.join(d, f), os.path.join(mixed_dir, f))
    mixed_out = os.path.join(tmp.name, "predict_mixed")
    mixed_argv = ["--input", mixed_dir] + image_argv[2:]
    reset_launches()
    pred_mixed, mixed_s, mixed_stage_s, mixed_det = run_image_predict(
        pipe, run_predict, mixed_argv + ["--out-dir", mixed_out])
    jpeg_launches = CR.faceid_raster_kernel.launches
    n_mixed = len(pred_mixed["names"])
    print(f"slice: predict of {n_mixed} images ({n_img} PNG + {len(mixed_jpegs)} JPEG) through "
          f"Keypoint-RCNN + PointRend R50-FPN at {DET_TEST}x{DET_TEST}, frame {DET_FRAME}, "
          f"first run: {mixed_s:.3f} s wall, face-id kernel launches {jpeg_launches} (rend 1 + "
          f"reposed 1); of the wall: " + ", ".join(f"{k} {v:.3f} s"
                                                    for k, v in mixed_stage_s.items()))
    if jpeg_launches != 2 or n_mixed != n_img + len(mixed_jpegs):
        raise AssertionError(f"mixed predict: {n_mixed} images, {jpeg_launches} face-id launches")
    check_image_predict("PointRend (PNG + JPEG)", pred_mixed, mixed_out, mixed_det, assets,
                        ckpt_pred, run_predict, faceid_errs)
    # verts_over_image_vis of two of the images (a PNG, a JPEG) on the card
    # and on the CPU: their inputs as the predict makes them.
    mixed_frames = pipe.read_images(mixed_dir, DET_FRAME, "cpu")[1]
    figure_inputs = []
    for name in (pred_mixed["names"][0], "progressive_420"):
        i = pred_mixed["names"].index(name)
        sil = np.load(os.path.join(mixed_out, "proxies", f"{name}_silhouette.npy"))
        crop = pipe.crop_image_like_proxy(sil, mixed_frames[i].numpy())
        v = torch.as_tensor(pred_mixed["verts"][i:i + 1])
        cam = torch.as_tensor(pred_mixed["cam_wp"][i:i + 1])
        verts2d = pipe.undo_keypoint_normalisation(pipe.orthographic_project(v, cam),
                                                   pipe.VERTS_VIS_WH)[0]
        figure_inputs.append((name, verts2d, torch.as_tensor(crop)))
        card_fig = figures.verts_over_image_figure(
            verts2d.to(dev), cv2_resize_linear_u8(torch.as_tensor(crop, device=dev), 512, 512))
        cpu_fig = figures.verts_over_image_figure(
            verts2d, cv2_resize_linear_u8(torch.as_tensor(crop), 512, 512))
        diff = (card_fig.cpu().to(torch.int64) - cpu_fig.to(torch.int64)).abs()
        saved = decode_png(os.path.join(mixed_out, "verts_vis", f"verts_{name}.png"))
        print(f"reference check, verts_over_image_vis of {name} ({len(verts2d)} vertices over "
              f"its 512x512 crop), card vs CPU: {int((diff > 0).any(-1).sum())} of "
              f"{diff.shape[0] * diff.shape[1]} pixels differ, largest {int(diff.max())} levels "
              f"(bound: none differ); the predict's file equal to the card's "
              f"{np.array_equal(saved, card_fig.cpu().numpy())}")
        if diff.max() > 0 or not np.array_equal(saved, card_fig.cpu().numpy()):
            raise AssertionError(f"verts_over_image_vis of {name}: card and CPU differ")

    # (c) The predict CLI over phase 4b's 64 cached proxies, read by the
    # native reader: its batch equals numpy's, and 64 400x400 3D scatters.
    sil_files = sorted(f for f in os.listdir(proxy_dir) if f.endswith("_silhouette.npy"))
    sil_paths = [os.path.join(proxy_dir, f) for f in sil_files]
    joint_paths = [p.replace("_silhouette.npy", "_joints2D.npy") for p in sil_paths]
    npy_paths = sil_paths + joint_paths
    native_sils = native_io.load_npy_batch(sil_paths, (512, 512))
    native_joints = native_io.load_npy_batch(joint_paths, (17, 2))
    same = (np.array_equal(native_sils, np.stack([np.load(p) for p in sil_paths]))
            and np.array_equal(native_joints, np.stack([np.load(p) for p in joint_paths])))
    cached_vis_out = os.path.join(tmp.name, "predict_cached_vis")
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        pred_cached = run_predict.main(["--input", proxy_dir, "--checkpoint", ckpt_pred,
                                        "--out-dir", cached_vis_out, "--device", "cuda"])
    cached_vis_launches = CR.faceid_raster_kernel.launches
    scatters = [decode_png(os.path.join(cached_vis_out, "verts_vis", f"verts_{name}.png"))
                for name in pred_cached["names"]]
    print(f"slice: {len(npy_paths)} cached npy files through the native reader equal to numpy's "
          f"{same}; predict over the {n} cached proxies: face-id launches "
          f"{cached_vis_launches}, {len(scatters)} verts_vis scatters of shapes "
          f"{sorted({a.shape for a in scatters})}")
    if (not same or cached_vis_launches != 2 or len(scatters) != n
            or any(a.shape != (400, 400, 4) for a in scatters)):
        raise AssertionError("cached predict through the native reader: proxies, launches or "
                             "scatters wrong")

    # 4j. The real-asset parity gate over stand-ins in the real formats:
    # (a) a reference additional/ directory, phase 4b's reference .tar and
    # phase 4d's three detectron2 pickles.
    from straps_tpu_torch.cli import run_parity_gate
    t_gate = time.perf_counter()
    gate_dir = os.path.join(tmp.name, "gate")
    smpl_dir = write_reference_additional_dir(os.path.join(gate_dir, "additional"))
    gate_common = ["--smpl-dir", smpl_dir, "--checkpoint", ckpt_pred, "--device", "cuda"]
    gate_det = ["--keypoint-checkpoint", pkls[0], "--silhouette-checkpoint", pkls[1],
                "--densepose-checkpoint", pkls[2]]

    def run_gate(label, argv, want_rc):
        """The gate's own verdict: its exit code and its table's rows."""
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = run_parity_gate.main(argv)
        text = out.getvalue()
        rows = gate_rows(text)
        verdict = "PARITY GATE: PASS" if rc == 0 else "PARITY GATE: FAIL"
        print(f"gate {label}: exit code {rc}, " + "; ".join(
            f"{k} {v[0]} ({v[1]})" for k, v in rows.items()))
        if rc != want_rc or verdict not in text:
            raise AssertionError(f"parity gate {label}: exit code {rc}, want {want_rc}\n{text}")
        return rows

    reset_launches()
    # (b) Every flag, over phase 4b's 64 cached proxies at 256x256, through
    # the module's own entry point.
    gate_cached = os.path.join(gate_dir, "cached")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "straps_tpu_torch.cli.run_parity_gate"] + gate_common + gate_det
        + ["--input", proxy_dir, "--out-dir", gate_cached], cwd=HERE, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=HERE), timeout=300)
    rows = gate_rows(proc.stdout)
    print(f"gate cached (python -m, {time.perf_counter() - t0:.2f} s): exit code "
          f"{proc.returncode}, " + "; ".join(f"{k} {v[0]} ({v[1]})" for k, v in rows.items()))
    want_rows = ["smpl_assets_load", "smpl_forward_oracle", "regressor_checkpoint",
                 "regressor_roundtrip", "keypoint_rcnn_convert", "pointrend_convert",
                 "densepose_convert", "demo_predict"]
    if (proc.returncode != 0 or "PARITY GATE: PASS" not in proc.stdout
            or list(rows) != want_rows or any(v[0] != "PASS" for v in rows.values())
            or not rows["demo_predict"][1].startswith(f"{n} images")):
        raise AssertionError(f"parity gate over the cached proxies:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    oracle_m = float(rows["smpl_forward_oracle"][1].split()[-2])
    print(f"gate: smpl_forward on the card against the float64 numpy LBS oracle: largest "
          f"vertex error {oracle_m:.3e} m (bound 1e-4 m)")
    # (c) The same gate through Keypoint-RCNN + PointRend over phase 4d's 16
    # PNGs at full width (512 frame, 800x800 detectors).
    rows = run_gate("pointrend", gate_common + gate_det + [
        "--silh-from", "pointrend", "--input", img_dir,
        "--out-dir", os.path.join(gate_dir, "pointrend")], 0)
    if not rows["demo_predict"][1].startswith(f"{n_img} images"):
        raise AssertionError("the PointRend gate did not predict every image")
    # (d) Against (b)'s outputs as the expected directory: PASS; then with
    # the expected vertices moved by 5 mm: FAIL, exit code 1.
    expected_argv = gate_common + ["--input", proxy_dir,
                                   "--out-dir", os.path.join(gate_dir, "again")]
    rows = run_gate("expected", expected_argv + ["--expected", gate_cached], 0)
    perturbed = os.path.join(gate_dir, "perturbed")
    os.makedirs(perturbed)
    for f in os.listdir(gate_cached):
        if f.endswith(".npy"):
            a = np.load(os.path.join(gate_cached, f))
            np.save(os.path.join(perturbed, f),
                    a + np.float32(0.005) if f.endswith("_verts.npy") else a)
    rows = run_gate("expected + 5 mm", expected_argv + ["--expected", perturbed], 1)
    if rows["expected_verts"][0] != "FAIL" or rows["expected_shape"][0] != "PASS":
        raise AssertionError("the 5 mm perturbation did not fail expected_verts alone")
    # (e) A Keypoint-RCNN pickle short of one backbone tensor: FAIL.
    import pickle
    with open(pkls[0], "rb") as f:
        short = dict(pickle.load(f, encoding="latin1")["model"])
    dropped = next(k for k in short if k.startswith("backbone.") and k.endswith(".weight"))
    del short[dropped]
    short_pkl = os.path.join(gate_dir, "short.pkl")
    with open(short_pkl, "wb") as f:
        pickle.dump({"model": short}, f, protocol=2)
    del short
    rows = run_gate("short pickle", ["--smpl-dir", smpl_dir, "--device", "cuda",
                                     "--keypoint-checkpoint", short_pkl], 1)
    if rows["keypoint_rcnn_convert"][0] != "FAIL" or dropped not in rows["keypoint_rcnn_convert"][1]:
        raise AssertionError("the short pickle did not fail keypoint_rcnn_convert by name")
    gate_s = time.perf_counter() - t_gate
    gate_launches = (CR.packed_raster_kernel.launches, CR.faceid_raster_kernel.launches)
    print(f"slice: parity gate phase {gate_s:.1f} s wall (bound 60 s); kernel launches "
          f"(packed, face-id) {gate_launches} (the gate predicts with save_vis=False)")
    if gate_launches != (0, 0):
        raise AssertionError("the parity gate launched a rasteriser kernel")
    if gate_s > 60.0:
        raise AssertionError(f"the parity gate phase took {gate_s:.1f} s, over 60 s")

    # 4k. The detector training side at R101-FPN width: DensePose's DeepLab
    # head, losses and data filter, PointRend's point sampling and loss,
    # card against CPU, and the DeepLab converters.  It launches neither
    # kernel.
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    reset_launches()
    for line in detector_training_side(card, pkls, frames):
        print(line)
    torch.cuda.synchronize()
    train_side_s = time.perf_counter() - t_train
    train_side_launches = (CR.packed_raster_kernel.launches, CR.faceid_raster_kernel.launches)
    print(f"slice: detector training side phase {train_side_s:.1f} s wall (bound 40 s); kernel "
          f"launches (packed, face-id) {train_side_launches}")
    if train_side_launches != (0, 0):
        raise AssertionError("the detector training side launched a rasteriser kernel")
    if train_side_s > 40.0:
        raise AssertionError(f"the detector training side took {train_side_s:.1f} s, over 40 s")
    torch.cuda.empty_cache()

    # 4l. The JAX package's orbax checkpoints: the committed fixture, and
    # phase 4c's trained state written as one and read at every entry point
    # that takes a checkpoint.
    t_orbax = time.perf_counter()
    orbax_lines, orbax_launches, orbax_ref = orbax_checkpoints(
        card, train_dir, train_cfg, proxy_dir, data, smpl_dir, os.path.join(tmp.name, "orbax"))
    for line in orbax_lines:
        print(line)
    print(f"slice: orbax checkpoint phase {time.perf_counter() - t_orbax:.1f} s wall; the "
          f"directory runs' kernel launches {orbax_launches}")
    torch.cuda.empty_cache()

    # 4n. Every other layout orbax writes: the committed layout fixtures,
    # and phase 4l's directory rewritten as zarr v2 without OCDBT, zarr3
    # with and without it, and zarr3 with bfloat16 parameters, read at the
    # predict, eval and resume entry points.
    t_layouts = time.perf_counter()
    layout_lines, layout_launches = orbax_layouts(
        card, assets, orbax_ref, train_dir, train_cfg, proxy_dir, data,
        os.path.join(tmp.name, "orbax_layouts"))
    for line in layout_lines:
        print(line)
    faceid_errs += layout_launches.pop("errs")
    layouts_s = time.perf_counter() - t_layouts
    print(f"slice: orbax layouts phase {layouts_s:.1f} s wall (target 30 s); the directory "
          f"runs' kernel launches {layout_launches}")
    torch.cuda.empty_cache()

    # 4m. Every PNG and JPEG form cv2.imread reads: the fixtures, the
    # predict CLI over those forms, the release-layout eval on silhouettes
    # stored in them, and one train epoch on the body model of seed 3.
    t_codings = time.perf_counter()
    codings_launches, codings_packed = image_codings(
        card, dev, assets, pipe, run_predict, run_eval, os.path.join(tmp.name, "codings_phase"), img_dir,
        pkls, ckpt_pred, ckpt, ssp3d, batch,
        [os.path.join(train_dir, os.path.dirname(train_cfg.log_path), f"synthetic_{s}.npz")
         for s in ("train", "val")], faceid_errs)
    print(f"slice: image codings phase {time.perf_counter() - t_codings:.1f} s wall")
    torch.cuda.empty_cache()

    # 4o. The port as `pip install .` installs it, in a process of its own:
    # the evaluation and predict slices again, from the installed files.
    t_installed = time.perf_counter()
    installed_lines, installed_launches = installed_copy(
        card, {"data": data, "ckpt": ckpt, "batch": batch, "n": n, "proxy_dir": proxy_dir,
               "ckpt_pred": ckpt_pred}, final, out_dir)
    for line in installed_lines:
        print(line)
    print(f"slice: installed copy phase {time.perf_counter() - t_installed:.1f} s wall; kernel "
          f"launches {installed_launches}")

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

    # The image slice: each detector's forward on a chunk of 8 (float32 and
    # bfloat16 backbone), then the warm image predict under the profiler,
    # with its peak device memory.
    det_frames = pipe.read_images(img_dir, DET_FRAME, dev)[1]
    detector_times(card, pkls, det_frames)
    image_cfg = PredictConfig(input_dir=img_dir, checkpoint=ckpt_pred, silhouettes_from="pointrend",
                              keypoint_checkpoint=pkls[0], silhouette_checkpoint=pkls[1],
                              out_dir=img_out)
    torch.cuda.reset_peak_memory_stats()
    profile_run(card, f"predict of {n_img} PNG images through both detectors at "
                f"{DET_TEST}x{DET_TEST}, renders included", n_img, "images",
                lambda: predict_3d(image_cfg, device="cuda"))
    print(f"times on {card}: image predict peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # The DensePose route: its detector on a chunk of 8 (float32 and
    # bfloat16 backbone) by stages, the warm DensePose image predict under
    # the profiler, and the warm release-layout evaluation.
    densepose_times(card, pkls[2], det_frames)
    dp_cfg = PredictConfig(input_dir=img_dir, checkpoint=ckpt_pred, silhouettes_from="densepose",
                           keypoint_checkpoint=pkls[0], silhouette_checkpoint=pkls[2],
                           out_dir=dp_out)
    torch.cuda.reset_peak_memory_stats()
    profile_run(card, f"predict of {n_img} PNG images through Keypoint-RCNN + DensePose-RCNN at "
                f"{DET_TEST}x{DET_TEST}, renders included", n_img, "images",
                lambda: predict_3d(dp_cfg, device="cuda"))
    print(f"times on {card}: DensePose image predict peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    release_data = load_eval_dataset(ssp3d)
    profile_run(card, f"eval of the {n}-sample SSP-3D release layout at 256x256, batch {batch}, "
                f"image-frame IoU", n, "samples",
                lambda: run_evaluation(release_data, PredictConfig(checkpoint=ckpt),
                                       batch_size=batch, device="cuda", iou_frame="image"))

    # Phase 4i's host and figure work, each a median of 5: the JPEG decoder
    # per fixture (host), the 128 cached npy files through the native
    # reader and through a numpy loop, the two figures per image on the
    # card (figure and PNG write), and the warm mixed-format predict.
    def median_s(fn, reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return float(np.median(ts))

    for name in sorted(jpeg_expected):
        path = os.path.join(jpeg_dir, name)
        shape = jpeg_expected[name]["shape"]
        print(f"times on {card}: decode_jpeg {name} ({shape[1]}x{shape[0]}) "
              f"{1e3 * median_s(lambda: decode_jpeg(path)):.3f} ms (host)")
    native_s = median_s(lambda: (native_io.load_npy_batch(sil_paths, (512, 512)),
                                 native_io.load_npy_batch(joint_paths, (17, 2))))
    numpy_s = median_s(lambda: (np.stack([np.load(p) for p in sil_paths]),
                                np.stack([np.load(p) for p in joint_paths])))
    print(f"times on {card}: load_npy_batch of {len(npy_paths)} cached npy files "
          f"({n} x 512x512 + {n} x 17x2 float32): native {1e3 * native_s:.3f} ms, numpy loop "
          f"{1e3 * numpy_s:.3f} ms (host)")
    fig_dir = os.path.join(tmp.name, "figures")
    for name, verts2d, crop in figure_inputs:
        v2, crop512 = verts2d.to(dev), cv2_resize_linear_u8(crop.to(dev), 512, 512)
        fig_s = median_s(lambda: figures.verts_over_image_figure(v2, crop512))
        vis_s = median_s(lambda: figures.verts_over_image_vis(
            v2, crop512, os.path.join(fig_dir, f"v_{name}.png")))
        print(f"times on {card}: verts_over_image_vis of {name} ({len(v2)} vertices) "
              f"{1e3 * vis_s:.3f} ms, of which the figure {1e3 * fig_s:.3f} ms")
    body = torch.as_tensor(pred_cached["verts"][0], device=dev)
    fig_s = median_s(lambda: figures.scatter_figure(body))
    vis_s = median_s(lambda: figures.scatter_vis(body, os.path.join(fig_dir, "s.png")))
    print(f"times on {card}: scatter_vis of one body ({len(body)} vertices) {1e3 * vis_s:.3f} ms, "
          f"of which the figure {1e3 * fig_s:.3f} ms")
    mixed_cfg = PredictConfig(input_dir=mixed_dir, checkpoint=ckpt_pred,
                              silhouettes_from="pointrend", keypoint_checkpoint=pkls[0],
                              silhouette_checkpoint=pkls[1], out_dir=mixed_out)
    mixed_warm_s = median_s(lambda: predict_3d(mixed_cfg, device="cuda"))
    print(f"times on {card}: warm predict of {n_mixed} images ({n_img} PNG + "
          f"{len(mixed_jpegs)} JPEG) through both detectors at {DET_TEST}x{DET_TEST}, "
          f"every vis file written: {mixed_warm_s:.3f} s wall, median of 5 "
          f"({n_mixed / mixed_warm_s:.2f} images/s)")

    # The train step at the released configuration (batch 140, 256x256,
    # bfloat16 encoder): the whole step as the loop runs it (draws,
    # synthetic batch, forward, backward, Adam, one host pull), then its
    # two halves, then three steps under the profiler, on the bodies of the
    # CLI's first train batch with its generator's draws.
    _, train_assets, state, train_step, _ = build_training(train_cfg, device=dev)
    pose, shape, gen = first_train_batch(train_cfg, corpus, dev)

    def draws():
        return draw_synthetic(gen, B, train_assets.num_verts, train_cfg, dev)

    def full_step():
        pull_to_host(*train_step(state, draws(), pose, shape))

    torch.cuda.reset_peak_memory_stats()
    step_times = synced_ms(full_step, warm=3, reps=12)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_med = float(np.median(step_times))
    synth_med = float(np.median(synced_ms(
        lambda: generate_synthetic_batch(draws(), pose, shape, train_assets, train_cfg),
        warm=1, reps=10)))
    batch_t = generate_synthetic_batch(draws(), pose, shape, train_assets, train_cfg)
    update_med = float(np.median(synced_ms(
        lambda: pull_to_host(*train_on_batch(state, batch_t, train_assets, train_cfg)),
        warm=1, reps=10)))
    print(f"times on {card}: warm train step at batch {B}, 256x256, bf16 encoder: median "
          f"{step_med:.2f} ms/step over {len(step_times)} steps ({B / step_med * 1e3:.1f} "
          f"samples/s; min {min(step_times):.2f}, max {max(step_times):.2f} ms; peak device "
          f"memory {peak_gib:.2f} GiB)")
    print(f"times on {card}: train step halves, medians of 10: draws + synthetic batch "
          f"{synth_med:.2f} ms, forward + backward + Adam + metrics + host pull "
          f"{update_med:.2f} ms (sum {synth_med + update_med:.2f} ms)")
    busy_ms = profile_run(card, f"3 train steps at batch {B}, 256x256", 3 * B, "samples",
                          lambda: [full_step() for _ in range(3)])
    if busy_ms is not None:
        print(f"times on {card}: device busy {busy_ms / 3:.2f} ms per profiled train step, "
              f"{100 * busy_ms / 3 / step_med:.1f}% of the median unprofiled step")
    del state, batch_t

    # The same step through the mesh path in an NCCL group of one, in a
    # spawned rank, against the plain path in the same rank, in turns.
    torch.cuda.empty_cache()
    (ddp_times, ddp_collectives, ddp_bytes, ddp_busy), = launch(
        ddp_step_times, 1, "cuda", args=(corpus,), timeout_s=600)
    def blocks(label):
        return " / ".join(f"{np.median(t):.2f} [{min(t):.2f}-{max(t):.2f}]"
                          for t in ddp_times[label])

    def per_step(busy_ms):
        return "not measured" if busy_ms is None else f"{busy_ms / 3:.2f} ms"
    print(f"times on {card}: warm train step at batch {B}, 256x256, bf16 encoder, in an NCCL "
          f"rank of one, medians [min-max] of 12 after 3 warm-up steps, in turns plain, mesh, "
          f"mesh, plain: plain {blocks('plain')} ms, through the mesh {blocks('mesh')} ms; a "
          f"mesh step issues {ddp_collectives} collectives reducing {ddp_bytes} bytes; device "
          f"busy per profiled step: plain {per_step(ddp_busy['plain'])}, mesh "
          f"{per_step(ddp_busy['mesh'])}")

    # The same at ResNet-50 with the silhouette task (64x64): the whole
    # step as the loop runs it, its peak memory, three steps under the
    # profiler; then the soft silhouette's forward and backward alone at
    # batch 140, on the first train batch's bodies at the mean camera.
    _, r50_assets, state, r50_step, _ = build_training(r50_cfg, device=dev)
    pose, shape, gen = first_train_batch(r50_cfg, corpus, dev)

    def r50_full_step():
        pull_to_host(*r50_step(state, draw_synthetic(gen, B, r50_assets.num_verts, r50_cfg,
                                                     dev), pose, shape))

    torch.cuda.reset_peak_memory_stats()
    r50_times = synced_ms(r50_full_step, warm=3, reps=12)
    r50_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r50_med = float(np.median(r50_times))
    print(f"times on {card}: warm ResNet-50 + silhouette (64x64) train step at batch {B}, "
          f"256x256, bf16 encoder: median {r50_med:.2f} ms/step over {len(r50_times)} steps "
          f"({B / r50_med * 1e3:.1f} samples/s; min {min(r50_times):.2f}, max "
          f"{max(r50_times):.2f} ms; peak device memory {r50_peak:.2f} GiB)")
    r50_busy = profile_run(card, f"3 ResNet-50 + silhouette train steps at batch {B}, 256x256",
                           3 * B, "samples", lambda: [r50_full_step() for _ in range(3)])
    if r50_busy is not None:
        print(f"times on {card}: device busy {r50_busy / 3:.2f} ms per profiled ResNet-50 + "
              f"silhouette train step, {100 * r50_busy / 3 / r50_med:.1f}% of the median "
              f"unprofiled step")
    del state
    verts = r50_assets.v_template[None].expand(B, -1, -1).clone().requires_grad_(True)
    cam = torch.tensor([0.9, 0.0, 0.2], device=dev).repeat(B, 1).requires_grad_(True)
    sil_fwd_ms = cuda_ms(lambda: soft_silhouette_from_wp(verts, cam, 64), 20)

    def sil_fwd_bwd():
        soft_silhouette_from_wp(verts, cam, 64).sum().backward()
    sil_ms = cuda_ms(sil_fwd_bwd, 20)
    print(f"times on {card}: soft silhouette at batch {B}, {verts.shape[1]} vertices, 64x64: "
          f"forward {sil_fwd_ms:.3f} ms, forward + backward {sil_ms:.3f} ms")
    del verts, cam

    # The packed kernel on the first train batch (the `kernels` line's
    # `train_*` numbers: the training step is its main consumer).
    train_kernel_ms = cuda_ms(
        lambda: CR.packed_raster_kernel(flat_t, bounds_t, attr_t, 256, 256), 200)
    train_plain_ms = cuda_ms(
        lambda: CR.rasterize_packed_reference(flat_t, bounds_t, attr_t, 256, 256), 2)
    train_bound_ms, train_bound_by = kernel_bound_ms(flat_t, bounds_t, 256, 256,
                                                     attr_t.numel() * 4, 4)
    print(f"times on {card}: packed raster kernel B={B} 256x256 on the first train batch "
          f"(culled, jittered cameras, vertex noise) {train_kernel_ms:.4f} ms (bound "
          f"{train_bound_ms:.4f} ms by {train_bound_by}, "
          f"{100 * train_bound_ms / train_kernel_ms:.1f}% of it); plain version "
          f"{train_plain_ms:.3f} ms")
    tmp.cleanup()

    print(f"chip_smoke: the whole run took {time.perf_counter() - t_main:.1f} s wall "
          f"(builds included)")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "raster_packed", "route": "cuda",
        "source": "straps_tpu_torch/csrc/raster_packed.cu",
        "replaces": "straps_tpu/render/pallas_raster.py:106",
        "inputs": f"ms, plain_ms, bound_ms: B=64 256x256 culled eval bodies; train_*: "
                  f"B={B} 256x256 first train batch (culled, jittered cameras, vertex noise); "
                  f"release_eval_launches: the {n}-sample SSP-3D-layout eval, image frame; "
                  f"r50_silhouette_train_launches: the ResNet-50 + silhouette train CLI; "
                  f"ddp_launches: phase 4h's ranks (NCCL step and eval, two gloo steps); "
                  f"orbax_launches: phase 4l's eval and one-epoch resume on the orbax "
                  f"directory; codings_launches: phase 4m's two release-layout evals "
                  f"(8-bit grey and other PNG forms) and its seed-3 train epoch; "
                  f"relayout_launches: phase 4n's eval on the zarr3 directory and one-epoch "
                  f"resume from the per-leaf zarr v2 one; installed_launches: phase 4o's eval "
                  f"from the installed files, in a process of its own",
        "launches": (launches + train_launches + r50_launches + ddp_launches
                     + orbax_launches["packed"] + codings_packed + layout_launches["packed"]
                     + installed_launches["raster_packed"]),
        "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "train_ms": train_kernel_ms, "train_plain_ms": train_plain_ms,
        "train_bound_ms": train_bound_ms, "train_bound_by": train_bound_by,
        "release_eval_launches": release_launches,
        "r50_silhouette_train_launches": r50_launches, "ddp_launches": ddp_launches,
        "orbax_launches": orbax_launches["packed"], "codings_launches": codings_packed,
        "relayout_launches": layout_launches["packed"],
        "installed_launches": installed_launches["raster_packed"]}, {
        "name": "raster_faceid", "route": "cuda",
        "source": "straps_tpu_torch/csrc/raster_faceid.cu",
        "replaces": "straps_tpu/render/pallas_raster.py:50",
        "inputs": f"B={n} 256x256 unculled predict rend bodies; image_path_launches and "
                  f"densepose_path_launches: the predicts from {n_img} PNG images through "
                  f"PointRend and DensePose (rend + reposed); r50_predict_launches: the "
                  f"predict of the {n} cached proxies with the ResNet-50 checkpoint; "
                  f"jpeg_path_launches: the predict of {n_mixed} PNG + JPEG images through "
                  f"PointRend; native_cached_launches: the predict of the {n} cached "
                  f"proxies read by the native reader, 3D scatters written; orbax_launches: "
                  f"phase 4l's predict of the {n} cached proxies on the orbax directory; "
                  f"codings_path_launches: phase 4m's predict over PNG and JPEG forms; "
                  f"relayout_path_launches: phase 4n's predicts of the {n} cached proxies on "
                  f"the four rewritten directories; installed_launches: phase 4o's predict of "
                  f"the {n} cached proxies from the installed files, in a process of its own",
        "launches": (faceid_launches + r50_predict_launches + jpeg_launches + cached_vis_launches
                     + orbax_launches["faceid"] + codings_launches + layout_launches["faceid"]
                     + installed_launches["raster_faceid"]),
        "max_abs_err": max(faceid_errs),
        "ms": faceid_ms,
        "plain_ms": faceid_plain_ms, "bound_ms": faceid_bound_ms,
        "bound_by": faceid_bound_by, "library_ms": None,
        "image_path_launches": image_launches, "densepose_path_launches": dp_launches,
        "r50_predict_launches": r50_predict_launches, "jpeg_path_launches": jpeg_launches,
        "native_cached_launches": cached_vis_launches,
        "orbax_launches": orbax_launches["faceid"],
        "codings_path_launches": codings_launches,
        "relayout_path_launches": layout_launches["faceid"],
        "installed_launches": installed_launches["raster_faceid"]},
        dict(batchnorm_entry, launches=train_bn_launches + r50_bn_launches,
             r18_train_launches=train_bn_launches, r50_train_launches=r50_bn_launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
