"""Configuration of the evaluation and predict paths: `ModelConfig`,
`PredictConfig` and the 'dotted.key=value' CLI overrides.

A copy of the inference part of `straps_tpu/config.py` (the training and
augmentation configs wait for the training slice).  Fields of paths the port
does not serve yet (the detector checkpoints and budgets) are left out.
"""

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence


@dataclass
class ModelConfig:
    resnet_in_channels: int = 18
    resnet_layers: int = 18
    ief_iters: int = 3
    # Encoder compute dtype; parameters, the IEF head and SMPL stay float32.
    # 'bfloat16' runs the encoder under autocast; None computes in float32.
    compute_dtype: Optional[str] = "bfloat16"


@dataclass
class PredictConfig:
    input_dir: str = "demo"
    checkpoint: Optional[str] = None
    # 'cached' reads `*_silhouette.npy` + `*_joints2D.npy`; the detector
    # front ends 'pointrend' and 'densepose' are not ported yet.
    silhouettes_from: str = "cached"
    proxy_dir: Optional[str] = None    # dir of cached proxies (default input_dir)
    # 'bfloat16' casts the proxy before the encoder (binary channels stay
    # exact, gaussian heatmap channels round).  None keeps float32.
    proxy_input_dtype: Optional[str] = None
    out_dir: str = "predict_out"
    img_wh: int = 256
    smpl_dir: Optional[str] = None
    # 'auto' resolves from the checkpoint: reference `.tar` checkpoints were
    # trained on legacy-grid heatmaps, no checkpoint -> 'clean'.
    heatmap_mode: str = "auto"         # 'auto' | 'clean' | 'legacy'
    model: ModelConfig = field(default_factory=ModelConfig)


def _apply_overrides(obj: Any, overrides: Dict[str, Any]) -> Any:
    """Apply {'a.b.c': value} overrides to a (nested) dataclass."""
    for key, value in overrides.items():
        parts = key.split(".")
        node = obj
        for p in parts[:-1]:
            node = getattr(node, p)
        cur = getattr(node, parts[-1])
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _apply_overrides(cur, value)
        else:
            if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
            setattr(node, parts[-1], value)
    return obj


def apply_cli_overrides(cfg, cli_overrides: Optional[Sequence[str]]):
    """Apply 'dotted.key=value' strings to a config in place (values parsed
    as Python literals, falling back to raw strings)."""
    for item in cli_overrides or []:
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        _apply_overrides(cfg, {key: value})
    return cfg
