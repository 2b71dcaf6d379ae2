"""Uniform draws from a `torch.Generator`, in the form of
`jax.random.uniform(key, shape, minval, maxval)`: `u * (hi - lo) + lo` for
u in [0, 1), with scalar or per-axis (broadcast) bounds.  The bounds are
float32 constants of the device, made once (`device_constant`)."""

import torch

from straps_tpu_torch.utils.device import device_constant


def uniform(generator: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    lo = device_constant(lo, torch.float32, device)
    hi = device_constant(hi, torch.float32, device)
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo
