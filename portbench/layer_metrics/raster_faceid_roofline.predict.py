"""The face-id rasteriser's share of its roofline on the predict path."""

from portbench.readers import raster_roofline_pct


def read(ctx):
    return raster_roofline_pct(ctx, "faceid")
