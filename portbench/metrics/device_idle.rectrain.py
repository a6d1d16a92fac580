"""Share of the traced recognition training window in which no kernel,
copy or set ran on the card (tracing.py: the union of device activity)."""


def read(ctx):
    if ctx.driver != "rectrain" or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
