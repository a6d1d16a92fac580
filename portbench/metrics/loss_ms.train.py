"""Stream milliseconds a training step spends over the program's
`jabd.train.loss` spans (the multibox loss, anchor matching with K2
included), between each span's CUDA events on the card's stream. The
card's idle inside the spans counts too (stream time, not kernel time)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "train", "jabd.train.loss", stream=True)
