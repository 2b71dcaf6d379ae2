"""Prediction CLI of the PyTorch port, over cached proxies or images:

    python -m straps_tpu_torch.cli.run_predict --input ./demo_proxies \
        --checkpoint straps_model_checkpoint.tar --out-dir predict_out
    python -m straps_tpu_torch.cli.run_predict --input ./photos --silh-from pointrend \
        --keypoint-checkpoint kp.pkl --silhouette-checkpoint pr.pkl \
        --checkpoint straps_model_checkpoint.tar --out-dir predict_out

With `--silh-from cached`, `--input` holds `<name>_silhouette.npy` +
`<name>_joints2D.npy` per image; with `--silh-from pointrend` or
`densepose`, `.png` and `.jpg` images (JPEGs decoded as cv2.imread decodes
them, CMYK and YCCK included; arithmetic-coded, lossless, hierarchical and
12-bit JPEGs are refused by name), which go through Keypoint-RCNN R50-FPN and
PointRend R50-FPN or DensePose-RCNN R101-FPN (detectron2 pickles).  Runs on
CUDA unless `--device cpu` is given.
"""

import argparse

from straps_tpu_torch.config import PredictConfig, apply_cli_overrides
from straps_tpu_torch.models.resnet import DEPTH_CONFIGS
from straps_tpu_torch.predict.pipeline import predict_3d

_DETECTOR_FLAGS = ("keypoint_checkpoint", "silhouette_checkpoint", "allow_random_detectors")


def build_parser():
    parser = argparse.ArgumentParser(description="Predict 3D human shape/pose")
    parser.add_argument("--input", required=True,
                        help="input dir: *.png and *.jpg images (--silh-from "
                             "pointrend|densepose) or cached proxies, *_silhouette.npy + "
                             "*_joints2D.npy")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format .tar, a training checkpoint .pt of "
                             "the port or an orbax checkpoint directory of the JAX "
                             "package; none = seeded random weights")
    parser.add_argument("--silh-from", default="cached",
                        choices=["cached", "pointrend", "densepose"],
                        help="'cached' proxies, or the detector front end with PointRend "
                             "('pointrend') or DensePose ('densepose') silhouettes")
    parser.add_argument("--out-dir", default="predict_out")
    parser.add_argument("--resnet-layers", type=int, default=18,
                        choices=sorted(DEPTH_CONFIGS),
                        help="the regressor's encoder depth (the checkpoint's)")
    parser.add_argument("--smpl-dir", default=None)
    parser.add_argument("--keypoint-checkpoint", default=None,
                        help="detectron2 pkl of Keypoint-RCNN R50-FPN")
    parser.add_argument("--silhouette-checkpoint", default=None,
                        help="detectron2 pkl of the silhouette detector: PointRend "
                             "R50-FPN (--silh-from pointrend) or DensePose-RCNN R101-FPN "
                             "(densepose_rcnn_R_101_FPN_s1x, --silh-from densepose)")
    parser.add_argument("--allow-random-detectors", action="store_true",
                        help="run the detector front end with seeded RANDOM weights "
                             "(meaningless proxies: smoke and throughput runs only)")
    parser.add_argument("--heatmap-mode", default="auto",
                        choices=["auto", "clean", "legacy"],
                        help="proxy heatmap distribution; 'auto' resolves "
                             "from the checkpoint (reference .tar -> 'legacy')")
    parser.add_argument("--no-vis", action="store_true",
                        help="write the npy predictions only, no renders")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    parser.add_argument("overrides", nargs="*",
                        help="key=value PredictConfig overrides (dotted "
                             "paths), e.g. img_wh=128 model.compute_dtype=None "
                             "detector_post_nms_topk=1000 detector_backbone_dtype=bfloat16")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f"--{f.replace('_', '-')}" for f in _DETECTOR_FLAGS if getattr(args, f)]
    if given and args.silh_from == "cached":
        parser.error(f"{' '.join(given)}: these flags serve only the detector front end "
                     f"(--silh-from pointrend|densepose)")
    cfg = PredictConfig(input_dir=args.input, checkpoint=args.checkpoint,
                        silhouettes_from=args.silh_from, out_dir=args.out_dir,
                        smpl_dir=args.smpl_dir, heatmap_mode=args.heatmap_mode,
                        keypoint_checkpoint=args.keypoint_checkpoint,
                        silhouette_checkpoint=args.silhouette_checkpoint,
                        allow_random_detectors=args.allow_random_detectors)
    cfg.model.resnet_layers = args.resnet_layers
    apply_cli_overrides(cfg, args.overrides)
    out = predict_3d(cfg, save_vis=not args.no_vis, device=args.device)
    print(f"predicted {len(out['names'])} images -> {args.out_dir}")
    for i, name in enumerate(out["names"]):
        print(f"  {name}: cam_wp={out['cam_wp'][i].round(3).tolist()} "
              f"betas[:3]={out['shape'][i][:3].round(3).tolist()}")
    return out


def script() -> int:
    """The `straps-predict-torch` console script: `main` over the process's arguments,
    exit status 0 on success (`main` returns its predictions, which
    `sys.exit` would print and turn into status 1)."""
    main()
    return 0


if __name__ == "__main__":
    main()
