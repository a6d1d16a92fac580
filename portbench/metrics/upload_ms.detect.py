"""Host milliseconds a detect_images call spends in the program's
`jabd.detect.upload` span: the host-to-device copies of the planned
inputs."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "detect", "jabd.detect.upload")
