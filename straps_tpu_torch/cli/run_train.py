"""Training CLI of the PyTorch port:

    python -m straps_tpu_torch.cli.run_train --config cfg.yaml \
        batch_size=140 lr=1e-4 train_path=data/train.npz

Runs on CUDA unless `--device cpu` is given.  `--synthetic-data` writes
small seeded pose/shape corpora (4 and 2 batches' worth) beside the log
file and trains on them, e.g. on the CPU:

    python -m straps_tpu_torch.cli.run_train --synthetic-data --device cpu \
        img_wh=64 batch_size=8 focal_length=1250.0 num_epochs=1

ResNet-50 with the silhouette task, and a `torch.profiler` trace of the
run (`DIR/trace.json`):

    python -m straps_tpu_torch.cli.run_train --synthetic-data --profile-dir DIR \
        model.resnet_layers=50 "losses_on=('verts', 'shape_params', \
        'pose_params', 'joints2D', 'joints3D', 'silhouette')" \
        "init_loss_weights={'verts': 1.0, 'joints2D': 0.1, 'pose_params': 0.1, \
        'shape_params': 0.1, 'joints3D': 1.0, 'silhouette': 1.0}"
"""

import argparse
import os

from straps_tpu_torch.config import TrainConfig, load_config
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.train.loop import train
from straps_tpu_torch.utils.device import resolve_device
from straps_tpu_torch.utils.profiling import trace


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the STRAPS regressor")
    parser.add_argument("--config", default=None, help="YAML config file")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="write small synthetic corpora beside the log "
                             "file and train on them (smoke runs)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a torch.profiler trace of the run into this "
                             "directory (trace.json, Chrome trace format)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides (dotted paths)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)     # raises before any file is written
    cfg = load_config(TrainConfig, args.config, args.overrides)
    if args.synthetic_data:
        data_dir = os.path.dirname(cfg.log_path) or "."
        cfg.train_path = write_synthetic_corpus(
            os.path.join(data_dir, "synthetic_train.npz"), n=max(cfg.batch_size * 4, 64))
        cfg.val_path = write_synthetic_corpus(
            os.path.join(data_dir, "synthetic_val.npz"), n=max(cfg.batch_size * 2, 32),
            seed=1)
    print(f"config: {cfg}")
    with trace(args.profile_dir):
        state, best_params, tracker = train(cfg, device=device)
    print(f"Training completed. Best val metrics (epoch {tracker.best_epoch}):",
          tracker.best_epoch_val_metrics)
    return state, best_params, tracker


if __name__ == "__main__":
    main()
