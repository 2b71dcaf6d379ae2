"""Mesh rasterisation: plane preparation, the CUDA rasterisers, renderer, vis."""
