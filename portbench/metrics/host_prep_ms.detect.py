"""Host milliseconds a detect_images call spends in the program's
`jabd.detect.prepare` span: the bucket, `plan_letterbox` of each image,
the stacks and `torch.from_numpy`."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "detect", "jabd.detect.prepare")
