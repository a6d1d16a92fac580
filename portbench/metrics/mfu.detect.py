"""Model FLOPs of the images detected in the traced window (convolutions
and matrix products of the reference model's forward at the cell's input
size, counts.model_flops) over the window at the bfloat16 dense peak."""

from portbench import counts


def read(ctx):
    if ctx.driver != "detect" or not ctx.images or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.flops_per_image() * ctx.images / (ctx.trace.window_s * counts.BF16_FLOPS)
