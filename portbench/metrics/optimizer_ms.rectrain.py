"""Stream milliseconds a recognition training step spends over the
program's `jabd.rectrain.optimizer` spans (the SGD update),
between each span's CUDA events on the card's stream. The card's idle
inside the spans, waiting for the host to launch their kernels, counts
too (stream time, not kernel time)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "rectrain", "jabd.rectrain.optimizer", stream=True)
