"""Kernel launches on the card per recognition training step in the
traced window."""


def read(ctx):
    if ctx.driver != "rectrain" or not ctx.calls or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.calls
