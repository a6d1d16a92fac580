"""Stream milliseconds a training step spends over the program's
`jabd.train.backward` spans (the backward pass), between each span's
CUDA events on the card's stream. The card's idle inside the spans,
waiting for the host to launch their kernels, counts too (stream time,
not kernel time)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "train", "jabd.train.backward", stream=True)
