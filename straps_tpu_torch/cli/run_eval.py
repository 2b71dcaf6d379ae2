"""Evaluation CLI of the PyTorch port:

    python -m straps_tpu_torch.cli.run_eval --dataset eval.npz \
        --checkpoint straps_model_checkpoint.tar --metrics pves silhouette_ious
    python -m straps_tpu_torch.cli.run_eval --dataset ssp_3d --iou-frame image

Runs on CUDA unless `--device cpu` is given.  Prints the final metrics as
JSON and returns them.  `--data-parallel-devices N` (N > 1) evaluates over
N ranks, one process each (`parallel.launch`: NCCL on `cuda:0..N-1`, gloo
with `--device cpu`); the batch size must divide by N.
"""

import argparse
import json

from straps_tpu_torch.config import PredictConfig, apply_cli_overrides
from straps_tpu_torch.eval_harness.datasets import load_eval_dataset
from straps_tpu_torch.eval_harness.runner import DEFAULT_METRICS, run_evaluation
from straps_tpu_torch.parallel.mesh import launch, make_mesh, requested_devices


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluate on SSP-3D/3DPW-style data")
    parser.add_argument("--dataset", required=True,
                        help="eval data: an SSP-3D release root (labels.npz + "
                             "silhouettes/), that labels.npz itself, a 3DPW root, or a "
                             "canonical eval npz (poses, shapes, optional genders, "
                             "silhouettes + joints2D)")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format .tar, a training checkpoint .pt of the port "
                             "or an orbax checkpoint directory of the JAX package; none = "
                             "seeded random weights")
    parser.add_argument("--metrics", nargs="+", default=list(DEFAULT_METRICS))
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--img-wh", type=int, default=256)
    parser.add_argument("--smpl-dir", default=None)
    parser.add_argument("--save-per-frame", default=None,
                        help="dir for per-frame metric npy dumps")
    parser.add_argument("--heatmap-mode", default="auto",
                        choices=["auto", "clean", "legacy"],
                        help="proxy heatmap distribution; 'auto' resolves "
                             "from the checkpoint (reference .tar -> 'legacy')")
    parser.add_argument("--iou-frame", default="crop", choices=["crop", "image"],
                        help="silhouette-IoU frame: 'crop' (the proxy crop the camera "
                             "lives in) or 'image' (the dataset's frame through the "
                             "inverse crop: the paper's SSP-3D mIoU protocol)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    parser.add_argument("--data-parallel-devices", type=int, default=0,
                        help="evaluate over this many ranks, one process each (0 or 1: "
                             "one process); --batch-size must divide by it")
    parser.add_argument("overrides", nargs="*",
                        help="key=value PredictConfig overrides (dotted "
                             "paths), e.g. model.compute_dtype=None")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = PredictConfig(checkpoint=args.checkpoint, img_wh=args.img_wh,
                        smpl_dir=args.smpl_dir, heatmap_mode=args.heatmap_mode)
    apply_cli_overrides(cfg, args.overrides)
    ranks = args.data_parallel_devices
    if ranks > 1:
        requested_devices(ranks, args.device)
        if args.batch_size % ranks:
            raise ValueError(f"--batch-size {args.batch_size} does not split over {ranks} "
                             f"ranks")
        final = launch(evaluate, ranks, args.device, args=(args, cfg))[0]
    else:
        final = evaluate(args, cfg)
    print(json.dumps(final, indent=2))
    return final


def evaluate(args, cfg: PredictConfig):
    """The final metrics of `args`' evaluation; in a process group (a rank
    of `parallel.launch`), over its data mesh."""
    mesh = None
    if args.data_parallel_devices > 1:
        mesh = make_mesh(args.data_parallel_devices, args.device)
    final = run_evaluation(load_eval_dataset(args.dataset), cfg,
                           metrics=tuple(args.metrics),
                           batch_size=args.batch_size,
                           save_per_frame=args.save_per_frame is not None,
                           save_path=args.save_per_frame, device=args.device,
                           iou_frame=args.iou_frame, mesh=mesh)
    return {k: float(v) for k, v in final.items()}


def script() -> int:
    """The `straps-eval-torch` console script: `main` over the process's arguments,
    exit status 0 on success (`main` returns its metrics, which
    `sys.exit` would print and turn into status 1)."""
    main()
    return 0


if __name__ == "__main__":
    main()
