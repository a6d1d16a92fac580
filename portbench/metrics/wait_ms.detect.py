"""Host milliseconds a detect_images call spends in the program's
`jabd.detect.download` span: the copies of the detections to the host,
where the host waits for the card to finish the call."""

from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "detect", "jabd.detect.download")
