"""Stream milliseconds a detect_images call spends over the program's
`jabd.detect.forward` span: the model's forward, between the span's CUDA
events on the card's stream. The card's idle inside the span counts too
(stream time, not kernel time)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "detect", "jabd.detect.forward", stream=True)
