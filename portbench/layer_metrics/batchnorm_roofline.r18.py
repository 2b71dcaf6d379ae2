"""The BatchNorm kernels' share of their roofline in the R18 training step."""

from portbench.batchnorm import batchnorm_roofline_pct


def read(ctx):
    return batchnorm_roofline_pct(ctx, "r18_train_b140")
