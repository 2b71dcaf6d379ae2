"""Model utilities (counterpart of `straps_tpu/utils/model_utils.py`)."""

from typing import Mapping, Union

import torch
from torch import nn

# BatchNorm statistics: state-dict entries that are not parameters.
_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def count_parameters(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Total parameter count of a module, or of a state dict without its
    BatchNorm statistics: on weights converted from flax it equals the JAX
    package's count over `params`."""
    if isinstance(model, nn.Module):
        return sum(p.numel() for p in model.parameters())
    return sum(int(v.numel()) if isinstance(v, torch.Tensor) else int(v.size)
               for k, v in model.items() if not k.endswith(_STATISTICS))
