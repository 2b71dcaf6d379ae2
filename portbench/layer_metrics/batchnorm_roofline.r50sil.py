"""The BatchNorm kernels' share of their roofline in the R50 + silhouette
training step."""

from portbench.batchnorm import batchnorm_roofline_pct


def read(ctx):
    return batchnorm_roofline_pct(ctx, "r50sil_train_b140")
