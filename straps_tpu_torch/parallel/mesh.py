"""Data-parallel process groups (counterpart of `straps_tpu/parallel/mesh.py`).

The JAX package's mesh is one program over many devices: XLA's SPMD
partitioner shards the batch over the `data` axis and inserts the gradient
all-reduce.  Here every device is a process, a rank of a
`torch.distributed` group that holds B/W rows of the global batch, and the
collectives are written out where the global batch needs them: the
BatchNorm statistics (`models/batchnorm.py`), the loss's counts
(`losses/multi_task.py`), the gradients and the reported losses
(`train/step.py`), and the gathered outputs and metrics (`gather_batch`).
A step over W ranks is then the step over the global batch.

Only two collectives are used, a SUM `all_reduce` and a `broadcast`: gloo
runs both on CPU and CUDA tensors, NCCL on CUDA tensors.  Every collective
issued through a `DataMesh` is counted on it (`collectives`,
`bytes_reduced`).

The JAX package's `batch_sharding` and `replicated_sharding` are
`NamedSharding` specs for `jax.device_put`; they have no torch meaning and
are not ported: `shard_batch` and `replicate` act on the tensors
themselves.
"""

import datetime
import os
import socket
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from straps_tpu_torch.utils.device import resolve_device

# A lost peer fails a collective after this long instead of hanging the run.
COLLECTIVE_TIMEOUT_S = 300.0


@dataclass(eq=False)
class DataMesh:
    """This process's place in a data-parallel group of `size` ranks."""
    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None    # a process group; None is the default group
    collectives: int = 0           # collectives issued through this mesh
    bytes_reduced: int = 0         # bytes of the tensors they reduced or broadcast


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Join the default process group at `tcp://<coordinator_address>`
    ('host:port') as rank `process_id` of `num_processes`.  No-op without
    an address (a single-process run)."""
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def requested_devices(num_devices: int = 0, device="cuda") -> int:
    """The number of ranks `num_devices` asks for on `device`: 0 means every
    visible card, or 1 on the CPU.  Asking for more cards than are visible
    raises, unless `device` names one card ('cuda:0') that every rank
    shares; the count is never silently shrunk."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return num_devices or 1
    visible = torch.cuda.device_count()
    n = num_devices or max(visible, 1)
    if dev.index is None and n > visible:
        raise ValueError(f"requested a {n}-device mesh but only {visible} "
                         f"device(s) are available")
    return n


def make_mesh(num_devices: int = 0, device="cuda") -> Optional[DataMesh]:
    """The data mesh of this process.

    In a process group of W ranks: a `DataMesh` of size W (`num_devices`
    must be 0 or W), whose device is `cuda:<rank>` for `device='cuda'`, or
    `device` itself when it names one card or the CPU.  Without a process
    group: None, the single-process path, for `num_devices` 0 or 1; a
    larger count raises (more cards than are visible, or a W-device mesh
    without its W processes: `launch` starts them, and the CLIs decide
    what their default 0 launches)."""
    if not dist.is_initialized():
        if num_devices > 1:
            requested_devices(num_devices, device)
            raise ValueError(f"a {num_devices}-device mesh needs {num_devices} processes "
                             f"in one group: start them with straps_tpu_torch.parallel."
                             f"launch (the CLIs do so for data_parallel_devices > 1)")
        return None
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices not in (0, size):
        raise ValueError(f"requested a {num_devices}-device mesh in a group of {size} "
                         f"processes")
    requested_devices(size, device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    return DataMesh(rank=rank, size=size, device=resolve_device(dev))


def batch_rows(batch_size: int, mesh: DataMesh) -> slice:
    """This rank's rows [r·B/W, (r+1)·B/W) of a global batch of B rows."""
    if batch_size % mesh.size:
        raise ValueError(f"a batch of {batch_size} does not split over {mesh.size} ranks")
    b = batch_size // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def _map(fn, tree):
    """`fn` on every leaf of a dict / NamedTuple / tuple / list tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: DataMesh):
    """This rank's rows (`batch_rows`) of every leaf of a global batch:
    tensors or numpy arrays, batch first."""
    return _map(lambda x: x[batch_rows(x.shape[0], mesh)], tree)


def _all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.collectives += 1
    mesh.bytes_reduced += t.numel() * t.element_size()
    return t


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: DataMesh) -> Sequence[torch.Tensor]:
    """Sum each tensor over the ranks, in place, through one flat buffer
    (one collective); the tensors share a dtype and a device."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the backward pass is a
    SUM all-reduce of the cotangents too, so each rank's gradient of its
    inputs is that of the sum of every rank's loss (each rank's loss must
    then be its share of the global loss)."""
    return _AllReduceSum.apply(x, mesh)


def gather_batch(tree, mesh: DataMesh):
    """The global batch of every leaf (tensors of one dtype, B/W rows on
    each rank) on every rank, rows in rank order: the rows written into a
    zero-filled (W, ...) buffer summed over the ranks, one collective."""
    leaves = []
    _map(leaves.append, tree)
    sizes = [t.numel() for t in leaves]
    buf = torch.zeros((mesh.size, sum(sizes)), dtype=leaves[0].dtype, device=leaves[0].device)
    buf[mesh.rank] = torch.cat([t.reshape(-1) for t in leaves])
    gathered = iter([part.reshape((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
                     for t, part in zip(leaves, _all_reduce(buf, mesh).split(sizes, dim=1))])
    return _map(lambda _: next(gathered), tree)


@torch.no_grad()
def replicate(obj, mesh: DataMesh):
    """Broadcast rank 0's values, in place, into a module's parameters and
    buffers or every tensor of a tree; returns `obj`."""
    tensors = (list(obj.parameters()) + list(obj.buffers())
               if isinstance(obj, torch.nn.Module) else [])
    if not isinstance(obj, torch.nn.Module):
        _map(tensors.append, obj)
    for t in tensors:
        dist.broadcast(t.detach(), src=0, group=mesh.group)
        mesh.collectives += 1
        mesh.bytes_reduced += t.numel() * t.element_size()
    return obj


def barrier(mesh: DataMesh) -> None:
    """Wait for every rank (an all-reduce of one element on the mesh's
    device)."""
    _all_reduce(torch.zeros(1, device=mesh.device), mesh)


def _rank_main(fn, rank, world, address, backend, device, args, kwargs, threads, out_dir):
    # The ranks share this host and meet at 127.0.0.1: their transports
    # take the loopback interface too.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank if dev.index is None else dev.index)
    initialize_distributed(address, world, rank, backend)
    try:
        torch.save(fn(*args, **kwargs), os.path.join(out_dir, f"rank{rank}.pt"))
    except Exception as e:
        # For the launcher's error; the traceback goes to stderr as usual.
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    finally:
        dist.destroy_process_group()


def _rank_failure(procs, out_dir) -> RuntimeError:
    r = next(r for r, p in enumerate(procs) if p.exitcode not in (None, 0))
    err = os.path.join(out_dir, f"rank{r}.err")
    why = open(err).read() if os.path.exists(err) else "no error recorded"
    return RuntimeError(f"rank {r} of {len(procs)} exited with code {procs[r].exitcode}: {why}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn: Callable, num_devices: int, device="cuda", args: Sequence = (),
           kwargs: Optional[dict] = None, timeout_s: Optional[float] = None) -> list:
    """Run `fn(*args, **kwargs)` in `num_devices` spawned processes, the ranks of one
    group at `tcp://127.0.0.1:<free port>`, and return their return values
    in rank order.

    `fn` must be importable by name (a module-level function).  Each rank
    runs on `cuda:<rank>` for `device='cuda'` (over NCCL), or on `device`
    itself when it names one card or the CPU (over gloo, which lets ranks
    share a card).  Each rank uses the
    caller's number of torch threads.  A rank that fails, or a run past
    `timeout_s`, kills every rank and raises."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and dev.index is None else "gloo"
    address = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, num_devices, address, backend, str(device),
                                   tuple(args), dict(kwargs or {}), torch.get_num_threads(),
                                   out_dir))
                 for rank in range(num_devices)]
        try:
            for p in procs:
                p.start()
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise _rank_failure(procs, out_dir)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{num_devices} ranks still running after {timeout_s} s")
                time.sleep(0.05)
            if any(p.exitcode != 0 for p in procs):
                raise _rank_failure(procs, out_dir)
            return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                    for r in range(num_devices)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
