"""Data-parallel dry run of the port (counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip` and `dryrun_multihost`):

    python -m straps_tpu_torch.parallel.dryrun N [--device cuda|cpu]

N processes join one group at `tcp://127.0.0.1:<free port>` (NCCL on N
cards, the default, which raises with fewer cards; gloo with `--device
cpu`).  Each loads its host shard of a small seeded corpus
(`epoch_batches(host_id=rank, num_hosts=N)`) and runs two train steps of
the global batch at 64x64 (two samples a rank), a `make_predict_fn(mesh=)`
fan-out held against the unsharded predict, and a checkpoint save (rank 0,
then a barrier) and restore (every rank) that must equal the saved state
bit for bit.
Prints rank 0's report as JSON.

Also holds the per-rank functions that the data-parallel tests and
`chip_smoke.py` run through `launch` (a spawned process imports its
function by name).
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from straps_tpu_torch.config import PredictConfig, TrainConfig
from straps_tpu_torch.data.dataset import SyntheticTrainingDataset, epoch_batches
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.eval_harness.runner import run_evaluation
from straps_tpu_torch.losses.multi_task import multi_task_loss
from straps_tpu_torch.parallel.mesh import (
    all_reduce_, all_reduce_sum, barrier, gather_batch, launch, make_mesh, replicate,
    requested_devices, shard_batch,
)
from straps_tpu_torch.predict.pipeline import load_regressor_variables, make_predict_fn
from straps_tpu_torch.smpl.assets import load_assets
from straps_tpu_torch.train.loop import build_training, params_to_host
from straps_tpu_torch.train.step import train_on_batch
from straps_tpu_torch.train.synthetic import SyntheticBatch, draw_synthetic, shard_draws
from straps_tpu_torch.utils.checkpoints import checkpoint_path, load_checkpoint, save_checkpoint

RANK_TIMEOUT_S = 600.0


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def train_steps(cfg: TrainConfig, steps, init=None) -> dict:
    """Train steps of global batches on the CPU, over this process's data
    mesh when it is a rank of a group (`launch`), else in one process.

    Each step is (draws, pose, shape), the augmented synthetic batch of
    those draws, or a `SyntheticBatch`; `init` is (model state dict,
    {task: log-variance}) to start from instead of the seeded state.
    Returns the state's digest and, on rank 0 (or without a mesh), each
    step's global loss, task losses and per-frame metrics, the gradients
    of the global loss, and the parameters, log-variances and BatchNorm
    running statistics after it, as numpy."""
    _, assets, state, train_step, _ = build_training(cfg, device="cpu")
    mesh = state.mesh
    if init is not None:
        state.model.load_state_dict(init[0])
        with torch.no_grad():
            for k, v in state.log_vars.items():
                v.copy_(torch.as_tensor(init[1][k]))

    def rows(tree):
        return tree if mesh is None else shard_batch(tree, mesh)

    record = []
    for step in steps:
        if isinstance(step, SyntheticBatch):
            loss, tasks, per_frame = train_on_batch(state, rows(step), assets, cfg)
        else:
            draws, pose, shape = step
            draws = draws if mesh is None else shard_draws(draws, mesh)
            loss, tasks, per_frame = train_step(state, draws, *rows((pose, shape)))
        named = dict(state.model.named_parameters())
        record.append({
            "loss": float(loss), "tasks": {k: float(v) for k, v in tasks.items()},
            "per_frame": _numpy(per_frame),
            "grads": {k: p.grad.numpy().copy() for k, p in named.items()},
            "log_var_grads": {k: float(v.grad) for k, v in state.log_vars.items()},
            "params": _numpy(named),
            "log_vars": {k: float(v.detach()) for k, v in state.log_vars.items()},
            "stats": {k: b.numpy().copy() for k, b in state.model.named_buffers()
                      if "running" in k}})
    lead = mesh is None or mesh.rank == 0
    return {"digest": state.digest(), "steps": record if lead else None}


def loss_and_grads(log_vars, labels, preds, img_wh: int) -> dict:
    """`multi_task_loss` of a global batch (numpy dicts, batch first) over
    this rank's data mesh: the global loss and task losses, the
    log-variances' gradients summed over the ranks, and the predictions'
    gradients gathered in global order."""
    mesh = make_mesh(0, "cpu")
    lv = {k: torch.tensor(np.float32(v), requires_grad=True) for k, v in log_vars.items()}
    pred = {k: torch.tensor(v, requires_grad=True) for k, v in shard_batch(preds, mesh).items()}
    label = {k: torch.as_tensor(v) for k, v in shard_batch(labels, mesh).items()}
    total, tasks = multi_task_loss(lv, label, pred, img_wh, mesh)
    total.backward()
    values = torch.stack([total.detach()] + [v.detach() for v in tasks.values()])
    lv_grads = [v.grad for v in lv.values()]
    all_reduce_(lv_grads + [values], mesh)
    return {"loss": float(values[0]),
            "tasks": {k: float(v) for k, v in zip(tasks, values[1:])},
            "log_var_grads": {k: float(g) for k, g in zip(lv, lv_grads)},
            "pred_grads": _numpy(gather_batch({k: v.grad for k, v in pred.items()}, mesh))}


def evaluate(dataset, cfg: PredictConfig, batch_size: int, **kw) -> dict:
    """`run_evaluation` on the CPU, over this process's data mesh when it is
    a rank of a group."""
    return run_evaluation(dataset, cfg, batch_size=batch_size, device="cpu",
                          mesh=make_mesh(0, "cpu"), **kw)


def predict(cfg: PredictConfig, proxies: np.ndarray) -> dict:
    """`make_predict_fn`'s predictions (numpy) of a global batch of proxies
    with `cfg`'s regressor on the CPU, over this process's data mesh when it
    is a rank of a group."""
    assets = load_assets(cfg.smpl_dir, device="cpu")
    model, _ = load_regressor_variables(cfg, assets, device="cpu")
    fn = make_predict_fn(model, assets, cfg.img_wh, mesh=make_mesh(0, "cpu"))
    return _numpy(fn(torch.as_tensor(proxies)))


def collectives_check() -> dict:
    """The mesh's collectives on this rank's CPU tensors: `all_reduce_sum`
    of 2x (forward and backward), `gather_batch`, `shard_batch`,
    `replicate` and `all_reduce_`, with the mesh's counters."""
    mesh = make_mesh(0, "cpu")
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    y = all_reduce_sum(2.0 * x, mesh)
    y.sum().backward()
    rows = torch.arange(6.0).reshape(3, 2) + 10.0 * mesh.rank
    gathered = gather_batch({"rows": rows, "ids": torch.full((3,), float(mesh.rank))}, mesh)
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(float(mesh.rank))
    replicate(module, mesh)
    summed = [torch.full((2,), float(mesh.rank)), torch.ones(3)]
    all_reduce_(summed, mesh)
    barrier(mesh)
    return {"rank": mesh.rank, "size": mesh.size, "y": y.detach().numpy(),
            "x_grad": x.grad.numpy(), "gathered": _numpy(gathered),
            "shard": shard_batch(np.arange(8), mesh),
            "weight": module.weight.detach().numpy(), "summed": [t.numpy() for t in summed],
            "collectives": mesh.collectives, "bytes_reduced": mesh.bytes_reduced}


def _equal(a, b) -> bool:
    """Bitwise equality of two checkpoint trees."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def dryrun_rank(corpus: str, work_dir: str, device: str) -> dict:
    """One rank of the dry run (module docstring)."""
    cfg = TrainConfig(img_wh=64, focal_length=1250.0, batch_size=2 * dist.get_world_size())
    cfg.model.compute_dtype = None
    model, assets, state, train_step, _ = build_training(cfg, device=device)
    mesh, dev = state.mesh, state.mesh.device
    batches = epoch_batches(SyntheticTrainingDataset(corpus), cfg.batch_size // mesh.size,
                            np.random.RandomState(0), host_id=mesh.rank, num_hosts=mesh.size)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    losses = []
    for _ in range(2):
        b = next(batches)
        draws = shard_draws(draw_synthetic(generator, cfg.batch_size, assets.num_verts, cfg,
                                           dev), mesh)
        loss, _, per_frame = train_step(state, draws, torch.as_tensor(b["pose"], device=dev),
                                        torch.as_tensor(b["shape"], device=dev))
        losses.append(float(loss))
        if not np.isfinite(losses[-1]) or any(v.shape[0] != cfg.batch_size
                                              for v in per_frame.values()):
            raise AssertionError(f"rank {mesh.rank}: step {len(losses)} gave loss "
                                 f"{losses[-1]} and per-frame rows "
                                 f"{[v.shape[0] for v in per_frame.values()]}")

    proxies = torch.rand((cfg.batch_size, cfg.img_wh, cfg.img_wh, 18),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    fanned = make_predict_fn(model, assets, cfg.img_wh, mesh=mesh)(proxies)
    whole = make_predict_fn(model, assets, cfg.img_wh)(proxies)
    predict_diff = max(float((fanned[k] - whole[k]).abs().max()) for k in whole)
    if fanned["verts"].shape[0] != cfg.batch_size or predict_diff > 1e-4:
        raise AssertionError(f"rank {mesh.rank}: the fanned-out predict gave "
                             f"{fanned['verts'].shape[0]} rows, {predict_diff} from the "
                             f"unsharded predict")

    path = checkpoint_path(os.path.join(work_dir, "dryrun"), 1)
    if mesh.rank == 0:
        save_checkpoint(path, state, epoch=1, best_epoch=1, best_params=params_to_host(model),
                        best_epoch_val_metrics={"pves_pa": losses[-1]})
    barrier(mesh)
    restored = load_checkpoint(path)
    if not _equal(restored["state"], state.state_dict()):
        raise AssertionError(f"rank {mesh.rank}: the restored checkpoint differs from the "
                             f"saved state")
    return {"rank": mesh.rank, "ranks": mesh.size, "device": str(dev), "losses": losses,
            "host_rows": int(b["pose"].shape[0]), "predict_rows": int(fanned["verts"].shape[0]),
            "predict_max_diff": predict_diff, "checkpoint_bitwise_equal": True,
            "digest": state.digest(), "collectives": mesh.collectives,
            "bytes_reduced": mesh.bytes_reduced}


def dryrun(num_devices: int, device: str = "cuda") -> dict:
    """Run the dry run over `num_devices` ranks; returns rank 0's report
    after checking that every rank ends with the same state."""
    requested_devices(num_devices, device)     # more cards than are visible raise here
    with tempfile.TemporaryDirectory() as work_dir:
        corpus = write_synthetic_corpus(os.path.join(work_dir, "corpus.npz"),
                                        n=8 * num_devices)
        reports = launch(dryrun_rank, num_devices, device, args=(corpus, work_dir, device),
                         timeout_s=RANK_TIMEOUT_S)
    if len({r["digest"] for r in reports}) != 1:
        raise AssertionError("the ranks' states differ after the dry run")
    return reports[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Data-parallel dry run over N processes")
    parser.add_argument("num_devices", type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cuda' (default: NCCL, one card a rank; raises with fewer "
                             "cards) or 'cpu' (gloo)")
    args = parser.parse_args(argv)
    report = dryrun(args.num_devices, args.device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
