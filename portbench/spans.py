"""What the readers of the program's own spans and counters share: the
latest profiler session of the served package's recorder
(jabd_tpu_torch/utils/tracing.py), read after the traced window's
synchronize. A served package without the recorder, or a window in which
it recorded nothing, reads None."""

from __future__ import annotations


def reading():
    """The recorder's `Reading` of the latest profiler session, or None."""
    try:
        from jabd_tpu_torch.utils import tracing
    except ImportError:
        return None
    r = tracing.read()
    return r if r.totals or r.counters else None


def ms_per_call(ctx, driver: str, name: str, stream: bool = False):
    """Milliseconds a call (a step) of the window spends in the spans named
    `name`: on the host clock, or with `stream` between each span's pair
    of CUDA events on the card's stream (the card's idle inside the span
    included: stream time, not kernel time)."""
    if ctx.driver != driver or not ctx.calls:
        return None
    r = reading()
    total = r.totals.get(name) if r is not None else None
    if total is None:
        return None
    ns = total.stream_ns if stream else total.host_ns
    return None if ns is None else ns / 1e6 / ctx.calls
