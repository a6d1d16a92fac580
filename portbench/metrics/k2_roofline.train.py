"""K2, the front half of anchor matching (csrc/matching.cu): its least
time over the traced steps (counts.py: 13 operations per (valid GT,
prior) in a 1024-prior tile the GT meets and 8 per (valid GT, tile) at
the float32 peak, or its bytes at the memory peak) over the device time
of its kernel."""

KERNELS = ("match_front_kernel",)


def read(ctx):
    if ctx.driver != "train":
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ctx.k2_bound_s() / seconds
