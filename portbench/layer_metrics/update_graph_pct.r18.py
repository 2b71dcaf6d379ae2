"""Of the traced training steps' updates, the share in % that replayed
the update's CUDA graph (`portbench/update_graph.py`)."""

from portbench.update_graph import update_graph_pct


def read(ctx):
    return update_graph_pct(ctx)
