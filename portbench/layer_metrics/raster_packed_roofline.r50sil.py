"""The packed rasteriser's share of its roofline on the training path."""

from portbench.readers import raster_roofline_pct


def read(ctx):
    return raster_roofline_pct(ctx, "packed")
