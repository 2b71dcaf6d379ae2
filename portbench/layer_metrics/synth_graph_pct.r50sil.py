"""Of the traced training steps' synthetic batches, the share in % that
replayed the batch's CUDA graph (`portbench/synth_graph.py`)."""

from portbench.synth_graph import synth_graph_pct


def read(ctx):
    return synth_graph_pct(ctx)
