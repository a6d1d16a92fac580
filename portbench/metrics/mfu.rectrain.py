"""Model FLOPs of the steps trained in the traced window (the reference
backbone's convolutions and matrix products, forward and backward at the
cell's image size, counts.model_flops, for every image, plus the margin
head's three products, 3 x 2 x B x D x C) over the window at the bfloat16
dense peak."""

from portbench import counts


def read(ctx):
    if ctx.driver != "rectrain" or not ctx.calls or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.flops_per_step() * ctx.calls / (ctx.trace.window_s * counts.BF16_FLOPS)
