#!/usr/bin/env python3
"""Convert an orbax training checkpoint of the JAX package (`straps_tpu`)
into a training checkpoint of the PyTorch port (`straps_tpu_torch`, `.pt`):

    python tools/export_jax_checkpoint.py CKPT_DIR OUT.pt [--config cfg.yaml] \
        [key=value ...]

`CKPT_DIR` is a directory written by `straps_tpu.utils.checkpoints.
save_checkpoint` (`<model_save_path>_epoch<N>`); the `TrainConfig`
overrides are the ones the JAX run was trained with (at least the model's:
`model.resnet_layers`, `model.resnet_in_channels`, `model.ief_iters`,
`losses_on`).  The state template is built from them, the checkpoint is
restored read-only, and the port's `.pt` gets everything the orbax one
holds: the weights and BatchNorm statistics, the loss log-variances,
Adam's moments and step count (so `resume_from_epoch` continues the JAX
run's optimiser trajectory), `epoch`, `best_epoch`, `best_params`,
`best_epoch_val_metrics` and `meta.heatmap_mode`.  Predict reads the `.pt`
(`run_predict --checkpoint OUT.pt`).

Runs only where JAX, flax, optax and orbax are installed, besides torch;
the port itself imports none of them and nothing of this script.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402

from straps_tpu.config import TrainConfig, load_config        # noqa: E402


def state_template(cfg: TrainConfig):
    """Zeros of the JAX `TrainState` that `cfg` trains (shapes and dtypes
    from `jax.eval_shape`: nothing is initialised), the tree orbax
    restores into."""
    from straps_tpu.losses import init_loss_log_vars
    from straps_tpu.models import build_regressor
    from straps_tpu.smpl import load_assets
    from straps_tpu.train.state import create_train_state, make_optimizer

    assets = load_assets(cfg.smpl_dir)
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape,
                            in_channels=cfg.model.resnet_in_channels,
                            resnet_layers=cfg.model.resnet_layers,
                            ief_iters=cfg.model.ief_iters,
                            compute_dtype=cfg.model.compute_dtype)

    def make():
        x = jnp.zeros((1, cfg.img_wh, cfg.img_wh, cfg.model.resnet_in_channels))
        variables = model.init(jax.random.PRNGKey(0), x, train=False)
        return create_train_state(variables["params"], variables["batch_stats"],
                                  init_loss_log_vars(cfg.losses_on, cfg.init_loss_weights),
                                  make_optimizer(cfg.lr))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(make))


def adam_state(opt_state):
    """The `ScaleByAdamState` of `optax.adam`'s chained state as numpy
    `{count, mu, nu}`."""
    adam, = [s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu")]
    return {k: jax.tree_util.tree_map(np.asarray, getattr(adam, k))
            for k in ("count", "mu", "nu")}


def export(ckpt_dir: str, out_path: str, cfg: TrainConfig) -> None:
    import torch

    from straps_tpu.utils.checkpoints import decode_meta_str, restore_checkpoint
    from straps_tpu_torch.models.convert import (
        flax_to_torch_state_dict, state_dict_to_tensors, train_state_from_flax,
    )
    from straps_tpu_torch.models.regressor import build_regressor
    from straps_tpu_torch.smpl.assets import load_assets
    from straps_tpu_torch.utils.checkpoints import save_checkpoint

    restored = restore_checkpoint(ckpt_dir, state_template(cfg))
    state = jax.tree_util.tree_map(np.asarray, restored["state"])
    assets = load_assets(cfg.smpl_dir, device="cpu")
    model = build_regressor(assets.mean_pose_6d, assets.mean_shape,
                            in_channels=cfg.model.resnet_in_channels,
                            resnet_layers=cfg.model.resnet_layers,
                            ief_iters=cfg.model.ief_iters,
                            compute_dtype=cfg.model.compute_dtype)
    # The log-variances in `losses_on` order, as the port's loop makes them
    # (its Adam holds them after the model's parameters, by position).
    log_vars = {k: state.log_vars[k] for k in cfg.losses_on}
    tstate = train_state_from_flax(state.params, state.batch_stats, log_vars, model, cfg.lr,
                                   device=torch.device("cpu"),
                                   opt_state=adam_state(state.opt_state))
    tstate.step = int(state.step)
    best_params = state_dict_to_tensors(flax_to_torch_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, restored["best_params"])}))
    meta = restored.get("meta")
    save_checkpoint(out_path, tstate, epoch=int(restored["epoch"]),
                    best_epoch=int(restored["best_epoch"]), best_params=best_params,
                    best_epoch_val_metrics={k: float(v) for k, v in
                                            restored["best_epoch_val_metrics"].items()},
                    heatmap_mode=decode_meta_str(meta["heatmap_mode"]) if meta else None)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a JAX (orbax) training checkpoint to the PyTorch port's .pt")
    parser.add_argument("checkpoint", help="orbax checkpoint directory of straps_tpu")
    parser.add_argument("out", help="the .pt to write")
    parser.add_argument("--config", default=None, help="the JAX run's YAML config")
    parser.add_argument("overrides", nargs="*",
                        help="the JAX run's key=value TrainConfig overrides")
    args = parser.parse_args(argv)
    cfg = load_config(TrainConfig, args.config, args.overrides)
    export(args.checkpoint, args.out, cfg)
    print(f"{args.checkpoint} -> {args.out} (ResNet-{cfg.model.resnet_layers}, "
          f"tasks {', '.join(cfg.losses_on)})")


if __name__ == "__main__":
    main()
