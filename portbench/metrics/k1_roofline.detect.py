"""K1, greedy NMS (csrc/nms.cu): its least time over the traced calls
(counts.py: operations of the reference's greedy NMS of each batch's
candidates at the float32 peak, or its bytes at the memory peak) over the
device time of its kernels."""

KERNELS = ("nms_mask_kernel", "nms_scan_kernel")


def read(ctx):
    if ctx.driver != "detect":
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ctx.k1_bound_s() / seconds
