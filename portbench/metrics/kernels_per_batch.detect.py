"""Kernel launches on the card per detect_images call in the traced window."""


def read(ctx):
    if ctx.driver != "detect" or not ctx.calls or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.calls
