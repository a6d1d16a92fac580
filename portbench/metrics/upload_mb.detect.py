"""Megabytes a detect_images call copies from the host to the card, from
the program's `detect.upload_bytes` counter (added inside the
`jabd.detect.upload` span: the sources and the letterbox plans). A served
package without the counter reads None."""

from portbench import spans


def read(ctx):
    if ctx.driver != "detect" or not ctx.calls:
        return None
    r = spans.reading()
    if r is None or "detect.upload_bytes" not in r.counters:
        return None
    return r.counters["detect.upload_bytes"] / 1e6 / ctx.calls
