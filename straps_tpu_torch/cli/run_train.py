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

`data_parallel_devices=N` trains the global batch over N ranks, one
process each (`parallel.launch`: NCCL on `cuda:0..N-1`, gloo with
`--device cpu`); 0, the default, is every visible card (1 on the CPU).
Rank 0 prints and writes the log, the checkpoints and the trace; `main`
then returns each rank's state digest (`TrainState.digest`).  Asking for
more cards than are visible raises before any file is written.
"""

import argparse
import os

import torch.distributed as dist

from straps_tpu_torch.config import TrainConfig, load_config
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.parallel.mesh import launch, requested_devices
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
    ranks = requested_devices(cfg.data_parallel_devices, device)     # so does this
    if args.synthetic_data:
        data_dir = os.path.dirname(cfg.log_path) or "."
        cfg.train_path = write_synthetic_corpus(
            os.path.join(data_dir, "synthetic_train.npz"), n=max(cfg.batch_size * 4, 64))
        cfg.val_path = write_synthetic_corpus(
            os.path.join(data_dir, "synthetic_val.npz"), n=max(cfg.batch_size * 2, 32),
            seed=1)
    print(f"config: {cfg}")
    if ranks > 1:
        return launch(train_rank, ranks, device, args=(cfg, str(device), args.profile_dir))
    return run(cfg, device, args.profile_dir)


def run(cfg: TrainConfig, device, profile_dir=None, lead: bool = True):
    """Train (under the profiler with `profile_dir`) and report the best
    validation metrics; returns (state, best parameters, tracker)."""
    with trace(profile_dir if lead else None):
        state, best_params, tracker = train(cfg, device=device)
    if lead:
        print(f"Training completed. Best val metrics (epoch {tracker.best_epoch}):",
              tracker.best_epoch_val_metrics)
    return state, best_params, tracker


def train_rank(cfg: TrainConfig, device: str, profile_dir=None) -> str:
    """One rank of a data-parallel run (`parallel.launch`); returns the
    digest of its final state."""
    return run(cfg, device, profile_dir, lead=dist.get_rank() == 0)[0].digest()


def script() -> int:
    """The `straps-train-torch` console script: `main` over the process's arguments,
    exit status 0 on success (`main` returns its training state, which
    `sys.exit` would print and turn into status 1)."""
    main()
    return 0


if __name__ == "__main__":
    main()
