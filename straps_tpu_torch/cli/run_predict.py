"""Prediction CLI of the PyTorch port, over cached proxies:

    python -m straps_tpu_torch.cli.run_predict --input ./demo_proxies \
        --checkpoint straps_model_checkpoint.tar --out-dir predict_out

`--input` holds `<name>_silhouette.npy` + `<name>_joints2D.npy` per image.
Runs on CUDA unless `--device cpu` is given.  The detector front end
(`--silh-from pointrend|densepose` and the detector checkpoints) is not
ported yet, and those flags are refused.
"""

import argparse

from straps_tpu_torch.config import PredictConfig, apply_cli_overrides
from straps_tpu_torch.predict.pipeline import predict_3d

_DETECTOR_FLAGS = ("keypoint_checkpoint", "silhouette_checkpoint", "allow_random_detectors")


def build_parser():
    parser = argparse.ArgumentParser(description="Predict 3D human shape/pose")
    parser.add_argument("--input", required=True,
                        help="input dir (cached proxies: *_silhouette.npy + "
                             "*_joints2D.npy)")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format .tar; none = seeded random weights")
    parser.add_argument("--silh-from", default="cached",
                        choices=["cached", "pointrend", "densepose"],
                        help="only 'cached' is ported; the detector front ends are refused")
    parser.add_argument("--out-dir", default="predict_out")
    parser.add_argument("--resnet-layers", type=int, default=18)
    parser.add_argument("--smpl-dir", default=None)
    parser.add_argument("--keypoint-checkpoint", default=None,
                        help="detector front end, not ported: refused")
    parser.add_argument("--silhouette-checkpoint", default=None,
                        help="detector front end, not ported: refused")
    parser.add_argument("--allow-random-detectors", action="store_true",
                        help="detector front end, not ported: refused")
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
                             "paths), e.g. img_wh=128 model.compute_dtype=None")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.silh_from != "cached":
        parser.error(f"--silh-from {args.silh_from}: the detector front end is not "
                     f"ported to PyTorch yet; use --silh-from cached")
    given = [f"--{f.replace('_', '-')}" for f in _DETECTOR_FLAGS if getattr(args, f)]
    if given:
        parser.error(f"{' '.join(given)}: the detector front end is not ported to "
                     f"PyTorch yet (these flags serve only --silh-from pointrend|densepose)")
    cfg = PredictConfig(input_dir=args.input, checkpoint=args.checkpoint,
                        silhouettes_from=args.silh_from, out_dir=args.out_dir,
                        smpl_dir=args.smpl_dir, heatmap_mode=args.heatmap_mode)
    cfg.model.resnet_layers = args.resnet_layers
    apply_cli_overrides(cfg, args.overrides)
    out = predict_3d(cfg, save_vis=not args.no_vis, device=args.device)
    print(f"predicted {len(out['names'])} images -> {args.out_dir}")
    for i, name in enumerate(out["names"]):
        print(f"  {name}: cam_wp={out['cam_wp'][i].round(3).tolist()} "
              f"betas[:3]={out['shape'][i][:3].round(3).tolist()}")
    return out


if __name__ == "__main__":
    main()
