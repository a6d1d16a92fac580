"""Spans and counters at the port's layer boundaries, recorded only while
a torch profiler records.

    with tracing.span("jabd.detect.forward", device):
        ...
    tracing.count("k1.pairs", n)

Off (no profiler recording: `torch.autograd.profiler._is_profiler_enabled`,
the flag torch sets when a profiler starts and clears when it stops), a
span is one shared no-op context and a count returns at once: one flag
read, no record_function, no CUDA event, nothing kept, no wait on the card.

On, a span enters `torch.profiler.record_function(name)`, so it is a host
range in the same kineto trace as the kernels, nested under whatever range
the caller opened (and written into `utils/profiling.py::trace`'s
`trace.json`). The recorder keeps sums by name only: spans, host ns
(`time.time_ns`), self host ns (less what the spans opened inside it on
the same thread cover) and, with a CUDA `device`, stream ns: the time
between a pair of timing events recorded on that device's current stream
at entry and exit. Stream time holds the card's idle inside the span, the
wait for the host to launch its work included, so it is not kernel time.
Timing events are added to the sums once they have completed and are then
reused; `read()` waits for those still open, so read after the work has
been synchronized.

Counters: `count` adds a host integer; `device_counts` hands kernels an
int64 tensor on the card that they add to (K1's, ops/nms_cuda.py), read
by `read()`.

Each profiler start opens a new session (torch calls
`autograd.profiler._run_on_profiler_start` there, torch 2.11 to 2.13 at
least; tests pin it); `read()` sees the latest one only. Under
torch.compile or torch.export tracing all stays off, so no profiler node
enters a compiled or exported graph.

Spans: `jabd.detect` (predict.py; children prepare, upload, letterbox,
forward, select, k1, compact, download, finish), `jabd.train.step` and
`jabd.rectrain.step` (step.py; augment, forward, loss > match or head,
backward, allreduce, optimizer), `jabd.serve.batch` (serve.py); of them
`jabd.detect.forward`, `jabd.train.{forward,loss,backward,optimizer}` and
`jabd.rectrain.{forward,head,backward,optimizer}` time the card.
Counters: `k1.pairs`, `k1.useful_pairs` (ops/nms_cuda.py).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
# Timed spans whose events may still be open before the recorder adds the
# completed ones to the sums (and reuses their events).
FOLD_AT = 256


class Total(NamedTuple):
    """A span name's sums: `self_ns` is host time less what the spans
    inside it cover; `stream_ns` the time between each span's events on
    the card (None where no span of the name timed the card)."""

    count: int
    host_ns: int
    self_ns: int
    stream_ns: Optional[int]


class Reading(NamedTuple):
    totals: Dict[str, Total]
    counters: Dict[str, int]


class _Session:
    """What one profiler session recorded."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals: Dict[str, list] = {}  # name -> [count, host_ns, self_ns, stream_ns or None]
        self.pending = collections.deque()  # (name, device, start event, end event)
        self.free: Dict[torch.device, list] = {}  # completed timing events, by device
        self.counts: Dict[str, int] = {}
        self.device_counts: Dict[tuple, torch.Tensor] = {}  # (names, device) -> int64 [len(names)]

    def events(self, device: torch.device):
        with self.lock:
            free = self.free.get(device)
            if free:
                return free.pop(), free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def close(self, name: str, host_ns: int, self_ns: int, device, events) -> None:
        with self.lock:
            total = self.totals.get(name)
            if total is None:
                total = self.totals[name] = [0, 0, 0, None]
            total[0] += 1
            total[1] += host_ns
            total[2] += self_ns
            if events is not None:
                total[3] = total[3] or 0
                self.pending.append((name, device, *events))
                if len(self.pending) >= FOLD_AT:
                    self.fold(wait=False)

    def fold(self, wait: bool) -> None:
        """Adds the pending spans' stream time to the sums, oldest first,
        up to the first still open (`wait`: all of them, waiting on the
        card). Under the lock."""
        while self.pending:
            name, device, start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            self.totals[name][3] += round(start.elapsed_time(end) * 1e6)
            self.free.setdefault(device, []).extend((start, end))


_session = _Session()
_local = threading.local()


def _new_session() -> None:
    global _session
    _session = _Session()


def _hook_profiler_start() -> None:
    """Open a new session each time a torch profiler starts recording
    (torch calls `_run_on_profiler_start` there, before it sets the flag).
    A torch without that function keeps one session."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "opens_tracing_session", False):
        return

    def run_on_profiler_start():
        _new_session()
        start()

    run_on_profiler_start.opens_tracing_session = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_hook_profiler_start()


_is_exporting = getattr(torch.compiler, "is_exporting", lambda: False)


def enabled() -> bool:
    """True while a profiler records (and no graph is being traced)."""
    return _profiler._is_profiler_enabled and not (torch.compiler.is_compiling() or _is_exporting())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "session", "device", "stream", "events", "parent", "t0", "child_ns", "rf")

    def __init__(self, name: str, device):
        self.name = name
        self.session = _session
        self.device = None
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda":
                self.device = device
        self.child_ns = 0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.events = self.session.events(self.device)
            self.events[0].record(self.stream)
        self.t0 = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        ns = time.time_ns() - self.t0
        if self.events is not None:
            self.events[1].record(self.stream)
        _stack().pop()
        if self.parent is not None:
            self.parent.child_ns += ns
        self.session.close(self.name, ns, ns - self.child_ns, self.device, self.events)
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """Context manager: the layer `name`, timed on the card's stream too
    where `device` is a CUDA device. Pass `device` only where a reader
    uses the stream time: under the profiler a pair of timing events slows
    a launch-bound step by far more than its own host time."""
    if not enabled():
        return _OFF
    return _Span(name, device)


def count(name: str, n: int) -> None:
    """Adds the host integer `n` to the counter `name`."""
    if not enabled():
        return
    session = _session
    with session.lock:
        session.counts[name] = session.counts.get(name, 0) + int(n)


def device_counts(names: Sequence[str], device) -> Optional[torch.Tensor]:
    """An int64 tensor on `device`, one zeroed slot per name of `names`,
    for kernels to add to; the session's one for these names and device,
    made at its first use. None while off."""
    if not enabled():
        return None
    key = (tuple(names), torch.device(device))
    session = _session
    with session.lock:
        slots = session.device_counts.get(key)
        if slots is None:
            slots = session.device_counts[key] = torch.zeros(len(key[0]), dtype=torch.int64, device=key[1])
    return slots


def read() -> Reading:
    """The sums by span name and the counters of the latest profiler
    session."""
    session = _session
    with session.lock:
        session.fold(wait=True)
        session.free.clear()
        totals = {name: Total(*t) for name, t in session.totals.items()}
        counters = dict(session.counts)
        slots = list(session.device_counts.items())
    for (names, _), values in slots:
        for name, v in zip(names, values.tolist()):
            counters[name] = counters.get(name, 0) + v
    return Reading(totals, counters)
