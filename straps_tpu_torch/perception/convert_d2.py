"""Detector weights: detectron2 pickles in and out, and the JAX detectors'
variables carried across (counterpart of `straps_tpu/perception/
convert_d2.py`).

The port's modules carry detectron2's names, so a detectron2 checkpoint is
a key filter plus tensors.  The models are built on the `meta` device and
take the checkpoint's tensors as they are (`load_state_dict(assign=True)`):
no random initialisation is spent on weights that are overwritten.
"""

import pickle
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

# Flax scope -> detectron2 module name, for the scopes without an index.
_RPN = {"conv": "conv", "objectness": "objectness_logits", "anchor_deltas": "anchor_deltas"}
_DECONV_NAMES = {"score_lowres", "ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres"}
# The DeepLab DensePose head's flax scopes -> detectron2's names (the
# inverse of the JAX `_map_densepose_head`).
_ASPP = {"conv1x1": "0.0", "gn1x1": "0.1", "atrous1": "1.0", "gn_atrous1": "1.1",
         "atrous2": "2.0", "gn_atrous2": "2.1", "atrous3": "3.0", "gn_atrous3": "3.1",
         "pool_conv": "4.1", "gn_pool": "4.2"}
_NONLOCAL = {"theta": "theta", "phi": "phi.0", "g": "g.0", "W": "W.0", "gn_w": "W.1"}
_DEEPLAB = {"aspp": lambda s: "ASPP.project.0" if s == "project" else f"ASPP.convs.{_ASPP[s]}",
            "nonlocal": lambda s: f"NLBlock.{_NONLOCAL[s]}"}
# FCs over a flattened (C, 7, 7) map: flax flattens (7, 7, C).
_FLATTEN_FC = {"roi_heads.box_head.fc1": 7, "roi_heads.mask_coarse_head.coarse_mask_fc1": 7}


def load_d2_pkl(path: str) -> Dict[str, torch.Tensor]:
    """A detectron2 pickle ({'model': {name: ndarray}}, read with
    `encoding='latin1'`) -> {name: float tensor} on the CPU."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f, encoding="latin1")
    state = ckpt.get("model", ckpt)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
            if isinstance(v, np.ndarray) or hasattr(v, "shape")}


def save_d2_pkl(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a state dict as a detectron2 pickle ({'model': {name: ndarray}})."""
    with open(path, "wb") as f:
        pickle.dump({"model": {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                                             else v) for k, v in state_dict.items()}}, f)


def load_detector_state(model: nn.Module, state: Dict[str, torch.Tensor],
                        device="cpu") -> nn.Module:
    """Give `model` (built on the `meta` device or anywhere) the tensors of
    `state` under its own names; other names in `state` (detectron2 keeps
    e.g. anchor buffers and the pixel statistics) are ignored.  Raises on a
    missing name or a wrong shape."""
    names = list(model.state_dict())
    missing = [k for k in names if k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's tensors, e.g. "
                       f"{missing[:5]}")
    model.load_state_dict({k: torch.as_tensor(state[k], dtype=torch.float32) for k in names},
                          strict=True, assign=True)
    return model.to(device).eval()


def _d2_module(path: Tuple[str, ...]) -> str:
    """A flax module path of the JAX detectors -> the detectron2 module name."""
    if path[0] == "trunk" and path[1] == "backbone":
        if path[2] == "fpn":
            m = re.fullmatch(r"(lateral|output)(\d)", path[3])
            return f"backbone.fpn_{m.group(1)}{m.group(2)}"
        sub = path[3:]
        if sub == ("conv1",):
            return "backbone.bottom_up.stem.conv1"
        if sub == ("bn1",):
            return "backbone.bottom_up.stem.conv1.norm"
        stage, block = re.fullmatch(r"layer(\d)_(\d+)", sub[0]).groups()
        base = f"backbone.bottom_up.res{int(stage) + 1}.{block}"
        inner = sub[1]
        if inner == "downsample_conv":
            return base + ".shortcut"
        if inner == "downsample_bn":
            return base + ".shortcut.norm"
        if inner.startswith("bn"):
            return f"{base}.conv{inner[2:]}.norm"
        return f"{base}.{inner}"
    if path[:2] == ("trunk", "rpn_head"):
        return f"proposal_generator.rpn_head.{_RPN[path[2]]}"
    if path[:2] == ("trunk", "box_head"):
        scope = "box_head" if path[2] in ("fc1", "fc2") else "box_predictor"
        return f"roi_heads.{scope}.{path[2]}"
    if path[0] == "densepose_head" and path[1] in ("aspp", "nonlocal"):
        return "roi_heads.densepose_head." + _DEEPLAB[path[1]](path[2])
    if path[0] == "densepose_head" and re.fullmatch(r"gn\d+", path[1]):
        return f"roi_heads.densepose_head.body_conv_fcn{path[1][2:]}.norm"
    scope = {"keypoint_head": "keypoint_head", "coarse_head": "mask_coarse_head",
             "point_head": "mask_point_head", "densepose_head": "densepose_head",
             "densepose_predictor": "densepose_predictor"}[path[0]]
    return f"roi_heads.{scope}.{path[1]}"


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def flax_detector_to_torch_state_dict(variables) -> Dict[str, np.ndarray]:
    """The JAX `KeypointRCNN` / `PointRendRCNN` / `DensePoseRCNN` variables
    (numpy arrays; the V1ConvX or the DeepLab DensePose head) ->
    the port's state dict under detectron2's names: the inverse of the JAX
    package's `convert_d2_state`.  Convolutions HWIO -> OIHW, the keypoint
    and DensePose deconvolutions flipped back to torch's (in, out, kh, kw),
    dense (in, out) -> (out, in), the FCs over a flattened map permuted HWC
    -> CHW, the point head's dense layers -> conv1d (out, in, 1), BatchNorm
    scale, bias and statistics -> FrozenBatchNorm's weight, bias, running
    mean and variance, GroupNorm scale and bias -> weight and bias."""
    out = {}
    for path, v in _leaves(variables["params"]):
        module, leaf = _d2_module(path[:-1]), path[-1]
        if module.endswith(".norm"):
            out[f"{module}.{'weight' if leaf == 'scale' else leaf}"] = v
        elif leaf == "bias":
            out[f"{module}.bias"] = v
        elif v.ndim == 4 and path[-2] in _DECONV_NAMES:
            out[f"{module}.weight"] = np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))
        elif v.ndim == 4:
            out[f"{module}.weight"] = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        elif module.startswith("roi_heads.mask_point_head"):
            out[f"{module}.weight"] = np.ascontiguousarray(v.T[:, :, None])
        elif module in _FLATTEN_FC:
            side = _FLATTEN_FC[module]
            w = v.T.reshape(v.shape[1], side, side, -1).transpose(0, 3, 1, 2)
            out[f"{module}.weight"] = np.ascontiguousarray(w.reshape(v.shape[1], -1))
        else:
            out[f"{module}.weight"] = np.ascontiguousarray(v.T)
    for path, v in _leaves(variables.get("batch_stats", {})):
        module = _d2_module(path[:-1])
        out[f"{module}.running_{path[-1]}"] = v
    return out
