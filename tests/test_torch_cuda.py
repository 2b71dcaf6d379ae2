"""The rasterisers' CUDA kernels against their plain versions, and the
detector front end's NMS and ROIAlign against the CPU, on the card.

Skipped where CUDA is absent.  On an H100:
`python -m pytest tests/test_torch_cuda.py -m cuda`.  Both sides round
every product and sum separately, so the packed keys, the face ids and
the depths agree exactly: on SMPL bodies at 64², 250² and 512² (two
256-column tiles), on the render of an augmented training batch, and on
the scenes of `tests/raster_scenes.py` (wide
triangles across tile edges, ragged widths, near-horizontal edges, vertices
on pixel centres, special planes, a coplanar tie across two chunks).
One ResNet-50 train step with the silhouette task on the card against the
CPU (`tests/torch_gates.py` replays the card's encoder selections), and
the DeepLab DensePose head with its losses and gradients.  A packed
launch captured in a `KernelGraph` counts at each replay.
"""

import numpy as np
import pytest
import torch

from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.geometry.camera import get_intrinsics_matrix
from straps_tpu_torch.predict.pipeline import predict_3d, save_proxies
from straps_tpu_torch.render import cuda_raster as CR
from straps_tpu_torch.render import raster as TR
from straps_tpu_torch.render import renderer
from straps_tpu_torch.render.renderer import render_rgb, render_silhouette
from straps_tpu_torch.smpl.assets import load_synthetic_assets
from straps_tpu_torch.smpl.model import smpl_forward_axis_angle
from straps_tpu_torch.train.synthetic import draw_synthetic, generate_synthetic_batch
from straps_tpu_torch.utils import native_build
from raster_scenes import KERNEL_SCENES
from torch_gates import count_flips, record_encoder_gates, replay_encoder_gates
from torch_margins import _check_margins

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _smpl_inputs(dev, img_wh, B=4, cull=True):
    assets = load_synthetic_assets(device=dev)
    g = torch.Generator().manual_seed(0)
    poses = (torch.randn(B, 72, generator=g) * 0.2).to(dev)
    shapes = (torch.randn(B, 10, generator=g) * 0.5).to(dev)
    verts = smpl_forward_axis_angle(assets, shapes, poses).vertices
    K = torch.as_tensor(get_intrinsics_matrix(img_wh, img_wh, 5000.0 * img_wh / 256), device=dev)
    cam_t = torch.tensor([0.0, 0.2, 42.0], device=dev).expand(B, 3)
    screen, z = TR.project_to_screen(verts, cam_t, K)
    planes = TR.prepare_face_planes(screen, z, assets.faces)
    dead = TR.backface_mask(screen, assets.faces) if cull else None
    if cull:
        planes = TR.kill_faces(planes, dead)
    bounds = TR.face_chunk_row_bounds(screen, assets.faces, CR.FACE_CHUNK, img_wh,
                                      dead_mask=dead)
    flat, attr = CR.pack_planes(planes, assets.face_parts)
    return flat, bounds.contiguous(), attr


@pytest.mark.parametrize("img_wh,cull", [(64, True), (64, False), (250, True), (512, True)])
def test_kernel_matches_plain(cuda, img_wh, cull):
    flat, bounds, attr = _smpl_inputs(cuda, img_wh, cull=cull)
    before = CR.packed_raster_kernel.launches
    got = CR.packed_raster_kernel(flat, bounds, attr, img_wh, img_wh)
    torch.cuda.synchronize()
    assert CR.packed_raster_kernel.launches == before + 1
    want = CR.rasterize_packed_reference(flat, bounds, attr, img_wh, img_wh)
    assert (want & 7).gt(0).float().mean() > 0.02
    assert torch.equal(got, want)


def test_graph_counts_captured_launches_at_each_replay(cuda):
    """A packed launch captured in a `KernelGraph` counts nothing while it
    is captured and once at each replay, which writes the plain version's
    keys."""
    flat, bounds, attr = _smpl_inputs(cuda, 64)
    CR.packed_raster_kernel(flat, bounds, attr, 64, 64)        # loads the library
    graph = native_build.KernelGraph()
    before = CR.packed_raster_kernel.launches
    with graph.capture():
        key = CR.packed_raster_kernel(flat, bounds, attr, 64, 64)
    assert CR.packed_raster_kernel.launches == before
    want = CR.rasterize_packed_reference(flat, bounds, attr, 64, 64)
    for replays in (1, 2):
        key.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert CR.packed_raster_kernel.launches == before + replays
        assert torch.equal(key, want)


def test_kernel_matches_plain_on_training_batch(cuda, monkeypatch):
    """The render of one augmented synthetic training batch (B=16, 256²:
    jittered cameras, vertex noise, back faces culled) launches the kernel
    once, on inputs whose keys equal the plain version's."""
    seen = []
    real = renderer.rasterize_packed

    def spy(planes, bounds, face_attr, img_h, img_w):
        seen.append((planes, bounds, face_attr, img_h, img_w))
        return real(planes, bounds, face_attr, img_h, img_w)
    monkeypatch.setattr(renderer, "rasterize_packed", spy)
    assets = load_synthetic_assets(device=cuda)
    cfg = TrainConfig(batch_size=16)
    g = torch.Generator().manual_seed(0)
    pose = (torch.randn(16, 72, generator=g) * 0.2).to(cuda)
    shape = (torch.randn(16, 10, generator=g) * 0.5).to(cuda)
    draws = draw_synthetic(torch.Generator(device=cuda).manual_seed(0), 16, assets.num_verts,
                           cfg, cuda)
    before = CR.packed_raster_kernel.launches
    batch = generate_synthetic_batch(draws, pose, shape, assets, cfg)
    assert CR.packed_raster_kernel.launches == before + 1 and len(seen) == 1
    assert torch.isfinite(batch.proxy).all() and batch.proxy[..., 0].mean() > 0.02
    planes, bounds, face_attr, img_h, img_w = seen[0]
    killed = (planes[:, :, 0] == torch.tensor([0.0, 0.0, -1.0], device=cuda)).all(dim=-1)
    assert 0.2 < killed.float().mean() < 0.8                   # back faces culled
    flat, attr = CR.pack_planes(planes, face_attr)
    bounds = bounds.to(torch.int32).contiguous()
    key = CR.packed_raster_kernel(flat, bounds, attr, img_h, img_w)
    assert torch.equal(key, CR.rasterize_packed_reference(flat, bounds, attr, img_h, img_w))


def test_render_silhouette_goes_through_kernel(cuda):
    assets = load_synthetic_assets(device=cuda)
    verts = assets.v_template[None].expand(2, -1, -1)
    K = torch.as_tensor(get_intrinsics_matrix(64, 64, 1250.0), device=cuda)
    cam_t = torch.tensor([0.0, 0.2, 42.0], device=cuda).expand(2, 3)
    before = CR.packed_raster_kernel.launches
    sil, _ = render_silhouette(verts, cam_t, K, assets.faces, 64, cull_backfaces=True)
    assert CR.packed_raster_kernel.launches == before + 1
    sil_cpu, _ = render_silhouette(verts.cpu(), cam_t.cpu(), K.cpu(),
                                   assets.faces.cpu(), 64, cull_backfaces=True)
    np.testing.assert_array_equal(sil.cpu().numpy(), sil_cpu.numpy())


@pytest.mark.parametrize("img_wh,cull", [(64, True), (64, False), (250, False),
                                         (512, False)])
def test_faceid_kernel_matches_plain(cuda, img_wh, cull):
    flat, bounds, _ = _smpl_inputs(cuda, img_wh, cull=cull)
    before = CR.faceid_raster_kernel.launches
    fid, depth = CR.faceid_raster_kernel(flat, bounds, img_wh, img_wh)
    torch.cuda.synchronize()
    assert CR.faceid_raster_kernel.launches == before + 1
    fid_p, depth_p = CR.rasterize_faceid_reference(flat, bounds, img_wh, img_wh)
    assert (fid_p >= 0).float().mean() > 0.02
    assert torch.equal(fid, fid_p) and torch.equal(depth, depth_p)
    assert torch.equal(depth == CR.FACEID_BG_DEPTH, fid < 0)


@pytest.mark.parametrize("scene", list(KERNEL_SCENES))
def test_kernels_match_plain_on_span_scenes(cuda, scene):
    flat, bounds, attr, img_h, img_w = (t.to(cuda) if torch.is_tensor(t) else t
                                        for t in KERNEL_SCENES[scene]())
    key = CR.packed_raster_kernel(flat, bounds, attr, img_h, img_w)
    fid, depth = CR.faceid_raster_kernel(flat, bounds, img_h, img_w)
    torch.cuda.synchronize()
    fid_p, depth_p = CR.rasterize_faceid_reference(flat, bounds, img_h, img_w)
    assert (fid_p >= 0).any()
    assert torch.equal(key, CR.rasterize_packed_reference(flat, bounds, attr, img_h, img_w))
    assert torch.equal(fid, fid_p) and torch.equal(depth, depth_p)
    if scene.startswith("coplanar tie"):
        assert set(fid.unique().tolist()) == {-1, 3, 5}


def test_render_rgb_goes_through_faceid_kernel(cuda):
    assets = load_synthetic_assets(device=cuda)
    verts = assets.v_template[None].expand(2, -1, -1)
    K = torch.as_tensor(get_intrinsics_matrix(64, 64, 1250.0), device=cuda)
    cam_t = torch.tensor([0.0, 0.2, 42.0], device=cuda).expand(2, 3)
    colors = torch.rand(assets.faces.shape[0], 3, generator=torch.Generator().manual_seed(0))
    before = CR.faceid_raster_kernel.launches
    rgb, depth = render_rgb(verts, cam_t, K, assets.faces, colors.to(cuda), 64)
    assert CR.faceid_raster_kernel.launches == before + 1
    rgb_cpu, depth_cpu = render_rgb(verts.cpu(), cam_t.cpu(), K.cpu(), assets.faces.cpu(),
                                    colors, 64)
    np.testing.assert_array_equal(rgb.cpu().numpy(), rgb_cpu.numpy())


def test_predict_3d_renders_in_two_launches(cuda, tmp_path):
    rng = np.random.RandomState(0)
    sils = np.zeros((3, 128, 128), np.float32)
    sils[:, 20:110, 40:90] = 1.0
    joints = rng.uniform(45, 85, (3, 17, 2)).astype(np.float32)
    save_proxies(str(tmp_path / "in"), ["a", "b", "c"], sils, joints)
    cfg = PredictConfig(input_dir=str(tmp_path / "in"), out_dir=str(tmp_path / "out"),
                        img_wh=64)
    before = CR.faceid_raster_kernel.launches
    out = predict_3d(cfg)
    assert CR.faceid_raster_kernel.launches == before + 2
    assert np.isfinite(out["verts"]).all()
    assert len(list((tmp_path / "out" / "rend_vis").iterdir())) == 6


def test_nms_on_card_matches_cpu(cuda):
    """The batched blocked NMS selects the same candidates on the card as on
    the CPU (an RPN-sized problem: 4 images, 4,500 candidates each)."""
    from straps_tpu_torch.perception.ops import nms_fixed

    g = torch.Generator().manual_seed(0)
    xy = torch.rand(4, 4500, 2, generator=g) * 700
    boxes = torch.cat([xy, xy + 20 + torch.rand(4, 4500, 2, generator=g) * 200], -1)
    scores = torch.rand(4, 4500, generator=g)
    scores[:, ::7] = -torch.inf
    want, want_v = nms_fixed(boxes, scores, 0.7, 512)
    got, got_v = nms_fixed(boxes.to(cuda), scores.to(cuda), 0.7, 512)
    assert torch.equal(got.cpu(), want) and torch.equal(got_v.cpu(), want_v)
    assert want_v.sum() > 400


@pytest.mark.parametrize("sampling_ratio,aligned", [(0, True), (2, True), (2, False)])
def test_roi_align_on_card_matches_cpu(cuda, sampling_ratio, aligned):
    from straps_tpu_torch.perception.ops import multilevel_roi_align, roi_align

    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 200 // 2 ** i, 200 // 2 ** i, 16, generator=g) for i in range(4)]
    xy = torch.rand(2, 64, 2, generator=g) * 600
    boxes = torch.cat([xy, xy + 4 + torch.rand(2, 64, 2, generator=g) * 300], -1).clamp(0, 800)
    want = multilevel_roi_align(feats, boxes, (4, 8, 16, 32), 7, sampling_ratio=sampling_ratio,
                                aligned=aligned)
    got = multilevel_roi_align([f.to(cuda) for f in feats], boxes.to(cuda), (4, 8, 16, 32), 7,
                               sampling_ratio=sampling_ratio, aligned=aligned)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    want = roi_align(feats[0], boxes, 0.25, 14, 1, mode="zeros")
    got = roi_align(feats[0].to(cuda), boxes.to(cuda), 0.25, 14, 1, mode="zeros")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_densepose_paste_on_card_matches_cpu(cuda):
    """detectron2's DensePose paste (resize to the integer box, argmax,
    paste) gives the same labels on the card: bilinear resampling may round
    differently only at float ties of the resized scores."""
    from straps_tpu_torch.perception.densepose import paste_part_labels

    g = torch.Generator().manual_seed(2)
    s = torch.randn(8, 15, 56, 56, generator=g)
    i = torch.randn(8, 25, 56, 56, generator=g)
    xy = torch.rand(8, 2, generator=g) * 400
    boxes = torch.cat([xy, xy + 0.5 + torch.rand(8, 2, generator=g) * 300], 1).clamp(0, 512)
    want = paste_part_labels(s, i, boxes, 512, 512)
    got = paste_part_labels(s.to(cuda), i.to(cuda), boxes.to(cuda), 512, 512)
    assert got.dtype == torch.uint8 and (want > 0).float().mean() > 0.05
    assert (got.cpu() != want).float().mean() < 1e-4


def test_densepose_forward_on_card_matches_cpu(cuda, monkeypatch):
    """DensePose-RCNN (R50 trunk for speed, 128², float32) on the card and
    on the CPU from the same seeded weights, the RPN's box deltas of order
    1 as trained ones are (`tests/test_torch_densepose.py`), on a seed
    whose CPU decisions clear their thresholds by 1e-4: the same
    detections, boxes within 0.1 px, part maps equal on 99% of the
    detections' pixels."""
    from straps_tpu_torch.perception.rcnn import DensePoseRCNN, init_random_weights
    from straps_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")                                   # float32 without TF32
    model = init_random_weights(DensePoseRCNN(backbone_depth=50, post_nms_topk=64,
                                              max_detections=4, output_part_maps=True),
                                torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.proposal_generator.rpn_head.anchor_deltas.weight *= 1e-2
        model.roi_heads.box_predictor.cls_score.bias[0] += 4.0
        model.roi_heads.densepose_predictor.ann_index_lowres.bias[1:] += 1.5
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(1)) * 250 - 120
    want = _check_margins(monkeypatch, model, x)
    monkeypatch.undo()
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in model.to(cuda)(x.to(cuda)).items()}
    valid = want["valid"]
    assert valid.any() and torch.equal(got["valid"], valid)
    assert (got["boxes"] - want["boxes"])[valid].abs().max() < 0.1
    assert (got["part_map"] == want["part_map"])[valid].float().mean() > 0.99


def test_resnet50_silhouette_train_step_on_card_matches_cpu(cuda):
    """One ResNet-50 train step with the silhouette task (64x64, B=8,
    float32 encoder) on the card and on the CPU from the same seeded state
    and draws: no IEF ReLU gate differs (the seed's smallest CPU
    pre-activation is 8.7e-5), loss and task losses within 1e-4 relative,
    BatchNorm running statistics within 1e-4 of each tensor's largest, and
    gradients within 2e-3 of each tensor's largest against the CPU step
    that replays the card's encoder selections (`torch_gates.py`: a few of
    its 6.4 million flip between the devices)."""
    from straps_tpu_torch.train.loop import build_training

    tasks = ("verts", "shape_params", "pose_params", "joints2D", "joints3D", "silhouette")
    weights = {"verts": 1.0, "joints2D": 0.1, "pose_params": 0.1, "shape_params": 0.1,
               "joints3D": 1.0, "silhouette": 1.0}
    cfg = TrainConfig(img_wh=64, batch_size=8, focal_length=1250.0, losses_on=tasks,
                      init_loss_weights=weights)
    cfg.model.compute_dtype = None
    cfg.model.resnet_layers = 50
    rng = np.random.RandomState(8)
    pose = torch.tensor((rng.randn(8, 72) * 0.2).astype(np.float32))
    shape = torch.tensor((rng.randn(8, 10) * 0.5).astype(np.float32))

    def step(device, replay=None):
        _, assets, state, train_step, _ = build_training(cfg, device=device)
        gates = []
        for fc in (state.model.ief_module.fc1, state.model.ief_module.fc2):
            fc.register_forward_hook(lambda m, i, o: gates.append(o.detach().cpu().flatten()))
        encoder = state.model.image_encoder
        if replay is None:
            enc = record_encoder_gates(encoder)
        else:
            enc = replay_encoder_gates(encoder, replay)
        draws = draw_synthetic(torch.Generator().manual_seed(8), 8, assets.num_verts, cfg,
                               "cpu")
        draws = type(draws)(*(type(d)(*(t.to(device) for t in d)) if isinstance(d, tuple)
                              else d.to(device) for d in draws))
        loss, task_losses, _ = train_step(state, draws, pose.to(device), shape.to(device))
        return (float(loss), {k: float(v) for k, v in task_losses.items()},
                {k: p.grad.cpu() for k, p in state.model.named_parameters()},
                {k: b.cpu() for k, b in state.model.named_buffers() if "running" in k},
                torch.cat(gates), enc)

    loss_k, tasks_k, grads_k, stats_k, gates_k, enc_k = step(cuda)
    loss_c, tasks_c, _, stats_c, gates_c, enc_c = step(torch.device("cpu"))
    grads_c = step(torch.device("cpu"), replay=enc_k)[2]
    print(f"encoder selections that differ: {count_flips(enc_k, enc_c)}")
    assert torch.equal(gates_k > 0, gates_c > 0)
    assert tasks_c["silhouette"] > 0
    assert abs(loss_k - loss_c) <= 1e-4 * abs(loss_c)
    for t, v in tasks_c.items():
        assert abs(tasks_k[t] - v) <= 1e-4 * abs(v), t
    for k, v in stats_c.items():
        assert (stats_k[k] - v).abs().max() <= 1e-4 * v.abs().max(), k
    for k, g in grads_c.items():
        assert (grads_k[k] - g).abs().max() <= 2e-3 * g.abs().max(), k


def test_deeplab_head_and_losses_on_card_match_cpu(cuda):
    """The DeepLab DensePose head (NonLocal on, its GroupNorm randomised),
    the predictor and `densepose_losses` with the backward on the card and
    on the CPU: the head output within 1e-4 of its largest, each loss term
    within 1e-5 relative, each parameter's gradient within 1e-3 of its
    largest (phi's bias: of its weight's).  In float64: at float32 this
    small head (8 ROIs, 2 convs) opens a few ReLU gates on one device only,
    and the ASPP weights' gradients then miss 1e-3 of their largest;
    `chip_smoke.py` phase 4k holds the full head in float32."""
    import copy

    from straps_tpu_torch.perception import densepose as TD
    from straps_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    g = torch.Generator().manual_seed(12)
    torch.manual_seed(12)
    head = TD.DensePoseDeepLabHead(256, 512, 2, use_nonlocal=True).double()
    with torch.no_grad():
        head.NLBlock.W[1].weight.uniform_(0.5, 1.5, generator=g)
    predictor = TD.DensePosePredictor(512).double()
    R, P = 8, 64
    x = torch.randn(R, 256, 14, 14, generator=g, dtype=torch.float64)
    targets = {"gt_segm": torch.randint(0, 15, (R, 56, 56), generator=g),
               "gt_points01": torch.rand((R, P, 2), generator=g, dtype=torch.float64),
               "gt_part": torch.randint(1, 25, (R, P), generator=g),
               "gt_u": torch.rand((R, P), generator=g, dtype=torch.float64),
               "gt_v": torch.rand((R, P), generator=g, dtype=torch.float64),
               "point_valid": torch.rand((R, P), generator=g) > 0.2}
    runs = []
    for dev in (cuda, torch.device("cpu")):
        h, p = copy.deepcopy(head).to(dev), copy.deepcopy(predictor).to(dev)
        out = h(x.to(dev))
        losses = TD.densepose_losses(*p(out), **{k: t.to(dev) for k, t in targets.items()})
        losses["total"].backward()
        runs.append((out.detach().cpu(), {k: v.item() for k, v in losses.items()},
                     {n: q.grad.cpu() for n, q in list(h.named_parameters())
                      + list(p.named_parameters())}))
    (ok, lk, gk), (oc, lc, gc) = runs
    assert (ok - oc).abs().max() <= 1e-4 * oc.abs().max(), float((ok - oc).abs().max())
    for k in lc:
        assert abs(lk[k] - lc[k]) <= 1e-5 * abs(lc[k]), (k, lk[k], lc[k])
    # phi's bias has a zero gradient in exact arithmetic (the softmax over
    # the keys ignores a shift every key shares): held at its weight's scale.
    scale_of = {"NLBlock.phi.0.bias": "NLBlock.phi.0.weight"}
    shares = {n: float((gk[n] - gc[n]).abs().max() / gc[scale_of.get(n, n)].abs().max())
              for n in gc}
    assert max(shares.values()) <= 1e-3, sorted(shares.items(), key=lambda kv: -kv[1])[:4]
