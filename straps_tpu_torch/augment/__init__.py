"""Synthetic-training augmentations (counterpart of `straps_tpu/augment/`).

Every function takes its random draws as tensor arguments, the values the
JAX package's `jax.random` calls give at the same places; each module's
`draw_*` function makes them from a `torch.Generator` on the tensors'
device.
"""
