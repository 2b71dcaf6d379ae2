"""The synthetic training path (counterpart of `straps_tpu/train/`)."""
