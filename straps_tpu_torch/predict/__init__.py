"""Inference: proxy construction, the batched prediction rollout,
`predict_3d` (counterpart of `straps_tpu/predict/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.predict.__all__` to its
counterparts here: every one has its own name.
"""

from straps_tpu_torch.predict.pipeline import (
    load_cached_proxies, load_regressor_variables, make_predict_fn, predict_3d,
    resolve_heatmap_mode,
)
from straps_tpu_torch.predict.proxy import (
    batch_silhouettes_joints_to_proxies, densepose_iuv_to_silhouette,
    silhouette_joints_to_proxy,
)

__all__ = [
    "silhouette_joints_to_proxy", "batch_silhouettes_joints_to_proxies",
    "densepose_iuv_to_silhouette", "make_predict_fn", "load_cached_proxies",
    "load_regressor_variables", "predict_3d", "resolve_heatmap_mode",
]

JAX_COUNTERPARTS = {name: (name,) for name in __all__}
