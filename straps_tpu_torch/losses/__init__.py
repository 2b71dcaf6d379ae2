"""Training losses (counterpart of `straps_tpu/losses/`)."""
