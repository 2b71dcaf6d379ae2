"""The selections of the port's regressor encoder (every ReLU's gate and the
max-pool's chosen index), recorded in one run and replayed in another.

A gradient is discontinuous where a selection flips: a ReLU input or two
max-pool candidates within two devices' rounding of each other pick
differently on each, and the gradients behind that element then differ by
its whole share.  A deep encoder has millions of selections (ResNet-50 at
64x64, B=8: 6.4 million), so a few flip between the card and the CPU
whatever the port does.  Replaying the card's selections on the CPU
compares the two devices' arithmetic on the same piecewise-linear branch.

Imports neither JAX nor the JAX package: `chip_smoke.py` and the card's
tests (`tests/test_torch_cuda.py`) use it.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn


def record_encoder_gates(encoder: nn.Module) -> List[torch.Tensor]:
    """Hooks on `encoder` that append, in call order, each ReLU call's gate
    (output > 0) and the max-pool's selected flat indices (torch's
    `max_pool2d(return_indices=True)`, the first maximum of each window)
    to the returned list."""
    gates: List[torch.Tensor] = []
    for m in encoder.modules():
        if isinstance(m, nn.ReLU):
            m.register_forward_hook(lambda m, i, o: gates.append((o > 0).detach()))
    pool = encoder.maxpool
    encoder.maxpool.register_forward_hook(lambda m, i, o: gates.append(F.max_pool2d(
        i[0].detach(), pool.kernel_size, pool.stride, pool.padding, return_indices=True)[1]))
    return gates


def replay_encoder_gates(encoder: nn.Module, gates: List[torch.Tensor]) -> None:
    """Make `encoder`'s ReLUs and max-pool take the recorded selections of
    another run, in call order: a ReLU gives `x * gate` (relu's value and
    gradient where the gate is relu's own), the max-pool the input at the
    recorded indices (max-pool's value and gradient where they are its
    own).  For one forward."""
    queue = iter(gates)

    def relu(x):
        return x * next(queue).to(x.device, x.dtype)

    def maxpool(x):
        idx = next(queue).to(x.device)
        out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        # In the input's memory layout (the proxy's NHWC is channels-last),
        # which picks the convolutions' summation order after it.
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        return out.contiguous(memory_format=fmt)

    for m in encoder.modules():
        if isinstance(m, nn.ReLU):
            m.forward = relu
    encoder.maxpool.forward = maxpool


def count_flips(a: List[torch.Tensor], b: List[torch.Tensor]) -> int:
    """Selections that differ between two recordings of the same forward."""
    return sum(int((x.cpu() != y.cpu()).sum()) for x, y in zip(a, b, strict=True))
