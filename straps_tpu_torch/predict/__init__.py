"""Inference: proxy construction, the batched prediction rollout, predict_3d."""
