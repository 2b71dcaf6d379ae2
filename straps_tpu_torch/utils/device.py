"""Device selection for the entry points.

Entry points run on `cuda` unless the caller asks for the CPU; asking for
CUDA without a card raises instead of falling back.  On CUDA the float32
path is pinned to full float32: the JAX reference computes at
`precision="highest"`, and cuDNN would otherwise run float32 convolutions
in TF32.

`device_constant` holds the small constant tensors that code on a hot
path would otherwise copy from the host on every call.
"""

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               f"available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _frozen(value):
    """`value` with every list and tuple turned into a tuple, so that it can
    key a cache."""
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    return value


@functools.lru_cache(maxsize=None)
def _constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


def device_constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)`, made once for each
    value (a Python number or nested list or tuple of them), dtype and
    device and kept for the life of the process.  It costs no host-to-device
    copy (and no wait) after its first call, so that a CUDA graph can
    capture the code that uses it; it is made outside inference mode, so a
    later autograd pass may save it.  A CUDA device without an index is
    the current one.  Callers must not write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _constant(_frozen(value), dtype, device)
