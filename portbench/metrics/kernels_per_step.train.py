"""Kernel launches on the card per training step in the traced window."""


def read(ctx):
    if ctx.driver != "train" or not ctx.calls or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.calls
