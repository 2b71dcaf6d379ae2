"""Typed configuration: `ModelConfig`, `PredictConfig`, the training and
augmentation configs, YAML loading and the 'dotted.key=value' CLI overrides.

A copy of `straps_tpu/config.py`, with the defaults of the reference's
released training configuration.  Two keys of the JAX package are
accepted with its defaults and change nothing the port computes:
`render` (`RenderConfig`: here the tensors' device picks the rasteriser,
the CUDA kernel on the card and its plain version on the CPU) and
`smpl_precision` (the port's SMPL is always full float32, TF32 off).  A
value the JAX training step raises on is refused here too, naming the key
(`check_jax_only_keys`).
"""

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    resnet_in_channels: int = 18
    resnet_layers: int = 18
    ief_iters: int = 3
    # Encoder compute dtype; parameters, the IEF head and SMPL stay float32.
    # 'bfloat16' runs the encoder under autocast; None computes in float32.
    compute_dtype: Optional[str] = "bfloat16"


@dataclass
class SmplAugmentConfig:
    augment_shape: bool = True
    delta_betas_distribution: str = "normal"        # 'normal' | 'uniform'
    delta_betas_std: float = 1.5
    delta_betas_range: Tuple[float, float] = (-3.0, 3.0)


@dataclass
class CamAugmentConfig:
    xy_std: float = 0.05
    delta_z_range: Tuple[float, float] = (-5.0, 5.0)


@dataclass
class BboxAugmentConfig:
    crop_input: bool = True
    mean_scale_factor: float = 1.2
    delta_scale_range: Tuple[float, float] = (-0.2, 0.2)
    delta_centre_range: Tuple[float, float] = (-5.0, 5.0)


@dataclass
class ProxyAugmentConfig:
    remove_appendages: bool = True
    deviate_joints2D: bool = True
    deviate_verts2D: bool = True
    occlude_seg: bool = True
    remove_appendages_classes: Tuple[int, ...] = (1, 2, 3, 4, 5, 6)
    remove_appendages_probabilities: Tuple[float, ...] = (
        0.1, 0.1, 0.1, 0.1, 0.05, 0.05)
    delta_j2d_dev_range: Tuple[float, float] = (-8.0, 8.0)
    delta_j2d_hip_dev_range: Tuple[float, float] = (-8.0, 8.0)
    delta_verts2d_dev_range: Tuple[float, float] = (-0.01, 0.01)
    occlude_probability: float = 0.5
    occlude_box_dim: int = 48


@dataclass
class RenderConfig:
    backend: str = "pallas"                         # 'pallas' | 'xla'
    interpret: bool = False                         # Pallas interpret (CPU)


# The values the JAX package's einsums take as `precision`: None, the
# `lax.Precision` strings and the `lax.DotAlgorithmPreset` names.
SMPL_PRECISIONS = (
    None, "default", "fastest", "high", "highest", "bfloat16", "bfloat16_3x",
    "tensorfloat32", "float32", "DEFAULT", "ANY_F8_ANY_F8_F32",
    "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY", "ANY_F8_ANY_F8_ANY_FAST_ACCUM",
    "F16_F16_F16", "F16_F16_F32", "BF16_BF16_BF16", "BF16_BF16_F32", "BF16_BF16_F32_X3",
    "BF16_BF16_F32_X6", "BF16_BF16_F32_X9", "TF32_TF32_F32", "TF32_TF32_F32_X3",
    "F32_F32_F32", "F64_F64_F64")


@dataclass
class TrainConfig:
    batch_size: int = 140
    lr: float = 1e-4
    num_epochs: int = 100
    epochs_per_save: int = 10
    img_wh: int = 256
    focal_length: float = 5000.0
    mean_cam_t: Tuple[float, float, float] = (0.0, 0.2, 42.0)
    losses_on: Tuple[str, ...] = (
        "verts", "shape_params", "pose_params", "joints2D", "joints3D")
    init_loss_weights: Dict[str, float] = field(default_factory=lambda: {
        "verts": 1.0, "joints2D": 0.1, "pose_params": 0.1,
        "shape_params": 0.1, "joints3D": 1.0})
    metrics_to_track: Tuple[str, ...] = (
        "pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc", "mpjpes",
        "mpjpes_sc", "mpjpes_pa", "shape_mses", "pose_mses", "joints2D_l2es")
    save_val_metrics: Tuple[str, ...] = ("pves_pa", "mpjpes_pa")
    train_path: str = "data/amass_up3d_3dpw_train.npz"
    val_path: str = "data/up3d_3dpw_val.npz"
    params_from: str = "all"
    model_save_path: str = "checkpoints/model_training/straps_model_checkpoint"
    log_path: str = "logs/straps_model_logs.pkl"
    resume_from_epoch: Optional[int] = None
    seed: int = 0
    smpl_dir: Optional[str] = None                  # None -> synthetic assets
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    smpl_augment: SmplAugmentConfig = field(default_factory=SmplAugmentConfig)
    cam_augment: CamAugmentConfig = field(default_factory=CamAugmentConfig)
    bbox_augment: BboxAugmentConfig = field(default_factory=BboxAugmentConfig)
    proxy_augment: ProxyAugmentConfig = field(default_factory=ProxyAugmentConfig)
    # Data-parallel ranks, one process each (0 = every visible card, 1 on
    # the CPU); the CLI launches them when there are more than one.
    data_parallel_devices: int = 0
    # The JAX package's SMPL matmul precision; the port's SMPL is float32.
    smpl_precision: Optional[str] = "highest"
    # 'clean' (centred Gaussian) | 'legacy' (the reference's linspace grid).
    heatmap_mode: str = "clean"
    # Grid side of the optional 'silhouette' task (the soft silhouette of
    # the predicted mesh against the proxy's silhouette resized to it).
    silhouette_loss_wh: int = 64


@dataclass
class PredictConfig:
    input_dir: str = "demo"
    checkpoint: Optional[str] = None
    # 'cached' reads `*_silhouette.npy` + `*_joints2D.npy`; 'pointrend' and
    # 'densepose' run Keypoint-RCNN with PointRend-RCNN R50-FPN or
    # DensePose-RCNN R101-FPN on `*.png` images.
    silhouettes_from: str = "cached"
    proxy_dir: Optional[str] = None    # dir of cached proxies (default input_dir)
    # detectron2 pickles of the two detectors (the silhouette one is
    # PointRend's or DensePose's, as `silhouettes_from`), read by name.
    keypoint_checkpoint: Optional[str] = None
    silhouette_checkpoint: Optional[str] = None
    # Without both checkpoints the front end refuses to run unless this is
    # set: random detectors give meaningless proxies (smoke runs only).
    allow_random_detectors: bool = False
    # 'bfloat16' runs the detectors' backbones and FPNs under autocast and
    # pools their ROIs in bfloat16; heads, NMS and masks stay float32.
    detector_backbone_dtype: Optional[str] = None
    # Detection budgets (defaults 512 proposals, 8 detections; detectron2
    # keeps 1000 and 100) and detectron2's ROI_HEADS.SCORE_THRESH_TEST.
    detector_post_nms_topk: Optional[int] = None
    detector_max_detections: Optional[int] = None
    detector_score_thresh: float = 0.05
    # The frame images are resized to (the reference's 512) and detectron2's
    # test size the detectors run at (800); smaller for CPU smoke runs.
    detector_image_size: int = 512
    detector_test_size: int = 800
    # 'bfloat16' casts the proxy before the encoder (binary channels stay
    # exact, gaussian heatmap channels round).  None keeps float32.
    proxy_input_dtype: Optional[str] = None
    out_dir: str = "predict_out"
    img_wh: int = 256
    smpl_dir: Optional[str] = None
    # 'auto' resolves from the checkpoint: reference `.tar` checkpoints were
    # trained on legacy-grid heatmaps, the port's training checkpoints
    # record their mode, no checkpoint -> 'clean'.
    heatmap_mode: str = "auto"         # 'auto' | 'clean' | 'legacy'
    model: ModelConfig = field(default_factory=ModelConfig)


def check_jax_only_keys(cfg: TrainConfig) -> None:
    """Raise ValueError, naming the key, on a `render.backend` or an
    `smpl_precision` that the JAX training step raises on."""
    if cfg.render.backend not in ("pallas", "xla"):
        raise ValueError(f"render.backend: unknown backend {cfg.render.backend!r} "
                         f"(want 'pallas' or 'xla')")
    if cfg.smpl_precision not in SMPL_PRECISIONS:
        raise ValueError(f"smpl_precision: {cfg.smpl_precision!r} is no matmul precision "
                         f"(want one of {SMPL_PRECISIONS})")


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


def load_config(cls, yaml_path: Optional[str] = None,
                cli_overrides: Optional[Sequence[str]] = None):
    """Build a config: defaults <- YAML file <- 'key=value' CLI overrides.
    PyYAML is imported only when a YAML file is given."""
    cfg = cls()
    if yaml_path:
        import yaml
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        _apply_overrides(cfg, data)
    return apply_cli_overrides(cfg, cli_overrides)
