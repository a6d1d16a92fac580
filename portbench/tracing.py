"""The traced window: torch.profiler (CUPTI) over the measured loop, reduced
in memory to what the per-layer readers and the breakdown need.

Device activity is every kernel, copy and set on the card. `busy_s` is
the length of the union of their intervals, `window_s` the traced
window's length (host clock, between two synchronizations). Each idle gap
between device intervals is named by the host activity that covered its
midpoint: the innermost host op or range open at that instant (the
benchmark's own ranges, `portbench.<call>`, enclose each call into the
program), so time the host spends outside any op reads as that range. No
trace file is written.
"""

from __future__ import annotations

import collections
import heapq
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

COPIES = ("Memcpy", "Memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # host activity -> seconds idle

    def kernel_seconds(self, names) -> float:
        """Seconds of the kernels whose names contain one of `names` as a
        whole identifier (template arguments and signatures allowed)."""
        pats = [re.compile(rf"(?<![\w]){re.escape(n)}(?![\w])") for n in names]
        return sum(s for op, s in self.device_ops.items() if any(p.search(op) for p in pats))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Window:
    """Context manager: profile the block on `device`; `.trace` afterwards."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter_ns()
        return self

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)
        return False


def _annotation(ev):
    """True for a record_function range, where the event says so; None
    where this torch's events do not tell."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    kind = getattr(ev, "activity_type", None)
    return "annotation" in str(kind()).lower() if kind is not None else None


def reduce(events, window_ns: int) -> Trace:
    """Kineto events of a window `window_ns` long -> Trace. Device events
    that merely project a host range onto the device's timeline are left
    out: flagged as annotations, or, where this torch does not flag them,
    named as a host event is (a kernel never is)."""
    device, host = [], []
    for ev in events:
        (device if str(ev.device_type()).endswith("CUDA") else host).append(ev)
    host_names = {ev.name() for ev in host}
    dev: List[Tuple[int, int]] = []
    by_name = collections.defaultdict(float)
    kernels = 0
    for ev in device:
        flag = _annotation(ev)
        if flag or (flag is None and ev.name() in host_names):
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        dev.append((start, start + dur))
        by_name[ev.name()] += dur / 1e9
        kernels += not ev.name().startswith(COPIES)
    window_s = window_ns / 1e9
    if not dev:
        return Trace(window_s=window_s, busy_s=0.0, kernels=0)
    dev.sort()
    merged = [list(dev[0])]
    for s, e in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    intervals = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()) for ev in host if ev.duration_ns() > 0)
    idle = collections.defaultdict(float)
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
    for (a, b), name in zip(gaps, _innermost(intervals, [(a + b) // 2 for a, b in gaps])):
        idle[name] += (b - a) / 1e9
    return Trace(window_s=window_s, busy_s=min(busy / 1e9, window_s), kernels=kernels,
                 device_ops=dict(by_name), idle_by_host=dict(idle))


def _innermost(intervals, times):
    """For each of the ascending `times`, the name of the latest-starting
    host interval that holds it ("no host op" where none does): a sweep
    with a heap of the open intervals by start."""
    names, heap, i = [], [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            heapq.heappush(heap, (-intervals[i][0], intervals[i][1], intervals[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "no host op")
    return names
