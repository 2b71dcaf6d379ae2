"""Uniform draws from a `torch.Generator`, in the form of
`jax.random.uniform(key, shape, minval, maxval)`: `u * (hi - lo) + lo` for
u in [0, 1), with scalar or per-axis (broadcast) bounds."""

import torch


def uniform(generator: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo
