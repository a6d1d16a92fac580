"""What the port's layer spans and K1's work counters (jabd_tpu_torch/utils/
tracing.py) cost, and whether the counters count what the kernels do, on
one CUDA card.

1. Off (no profiler): host microseconds a `span(...)` with its `with`
   takes, and a `tracing.enabled()` check, over 1,000,000 calls each.
2. On (torch.profiler over CPU and CUDA): host microseconds a span takes
   without a device and with a CUDA device (its pair of timing events,
   reused once complete), over 20,000 spans each; then the parts of the
   difference: `torch.cuda.current_stream(device)`, a timing event made,
   recorded the first time (it is created then), recorded again, queried,
   and the elapsed time of a pair.
3. K1 (csrc/nms.cu) under a profiler, on chip_smoke.py's phase-1 inputs
   (IoU and DIoU, valid prefixes and scattered, K 64 to 12,288, two forced
   plans: other cluster widths and chunks, the overflow list in use) and
   K 67,200 at B 2: the keep mask
   equals the plain version's and the untraced kernel's, `k1.pairs` and
   `k1.useful_pairs` equal a count of the kernels' work from the inputs and
   the plain keep mask, and a traced call launches no kernel but K1's,
   save one fill of the counters a profiler session.

Prints one JSON line last, {"ok": ...}. Run from the repository root on a
machine with one card:
    python3 scripts/probe_tracing_cost.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from jabd_tpu_torch import _build  # noqa: E402
from jabd_tpu_torch.ops import nms as N  # noqa: E402
from jabd_tpu_torch.ops import nms_cuda  # noqa: E402
from jabd_tpu_torch.utils import tracing as T  # noqa: E402

OFF_CALLS, ON_CALLS = 1_000_000, 20_000


def per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e6


def spans(n, device=None):
    for _ in range(n):
        with T.span("jabd.detect.prepare", device):
            pass


def checks(n):
    for _ in range(n):
        T.enabled()


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def kernels(prof) -> list:
    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()
            and not ev.name().startswith(("Memcpy", "Memset"))]


def k1_cases():
    """chip_smoke.nms_phase's inputs, forced plans included, then K 67,200."""
    for k in (5000, 4999):
        boxes, valid = chip_smoke.nms_cases(k, seed=k)
        for kind in ("iou", "diou"):
            yield f"K={k} {kind}", boxes, valid, 0.3, kind, None
    boxes, valid = chip_smoke.nms_cases(5000, seed=1)
    scattered = torch.from_numpy(np.random.default_rng(1).random(tuple(valid.shape)) < 0.6)
    yield "K=5000 iou valid not a prefix", boxes, scattered, 0.3, "iou", None
    yield "K=5000 diou thr=-0.1", boxes, valid, -0.1, "diou", None
    for k in (64, 65):
        small, small_valid = chip_smoke.nms_cases(k, seed=k)
        yield f"K={k} iou", small, small_valid, 0.3, "iou", None
    large, large_valid = chip_smoke.nms_cases(12288, seed=12288)
    yield "K=12288 iou", large[[3, 6]], large_valid[[3, 6]], 0.3, "iou", None
    boxes, valid = chip_smoke.nms_cases(5000, seed=5000)
    yield "K=5000 iou, width 16 chunk 64 cap 3", boxes, valid, 0.3, "iou", \
        chip_smoke.forced_plan(8, 5000, 16, 64, 3)
    yield "K=5000 diou, width 2 chunk 128 cap 40", boxes, valid, 0.3, "diou", \
        chip_smoke.forced_plan(8, 5000, 2, 128, 40)
    g = torch.Generator().manual_seed(67200)
    xy = torch.rand(2, 67200, 2, generator=g)
    wh = torch.rand(2, 67200, 2, generator=g) * 0.05
    yield "K=67200 B=2 iou all valid", torch.cat([xy, xy + wh], -1), torch.ones(2, 67200, dtype=torch.bool), \
        0.3, "iou", None


def counters_phase(dev) -> bool:
    ok = True
    plan = nms_cuda.plan
    for name, boxes, valid, thr, kind, forced in k1_cases():
        boxes, valid = boxes.to(dev).contiguous(), valid.to(dev).contiguous()
        pl = forced or plan(*valid.shape)
        if forced is not None:
            nms_cuda.plan = lambda *args, pl=forced: pl
        try:
            untraced = nms_cuda.nms_keep_sorted(boxes, valid, thr, kind)
            torch.cuda.synchronize()
            with profile() as prof:
                first = nms_cuda.nms_keep_sorted(boxes, valid, thr, kind)
                traced = nms_cuda.nms_keep_sorted(boxes, valid, thr, kind)
                torch.cuda.synchronize()
        finally:
            nms_cuda.plan = plan
        want = N.nms_keep_sorted(boxes, valid, thr, kind)
        c = T.read().counters
        pairs, useful = chip_smoke.k1_work(valid, want, pl.chunk)
        same = torch.equal(untraced, want) and torch.equal(first, want) and torch.equal(traced, want)
        counted = c == {"k1.pairs": 2 * pairs, "k1.useful_pairs": 2 * useful}
        launched = len(kernels(prof))
        others = [k for k in kernels(prof) if "nms_" not in k]
        ok &= same and counted and launched <= 3 and len(others) <= 1
        print(f"[k1] {name}: width {pl.width} chunk {pl.chunk}, masks equal {same}, counters {c} against twice "
              f"({pairs}, {useful}): {counted}; kernels {launched} for 2 calls (K1's 2; "
              f"others {[k[:60] for k in others]}); "
              f"useful share {100.0 * useful / max(pairs, 1):.3f}%")
    return ok


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    hook = getattr(torch.autograd.profiler._run_on_profiler_start, "opens_tracing_session", False)
    print(f"[flag] the session hook wraps torch.autograd.profiler._run_on_profiler_start: {hook}")
    with profile():
        T.count("k1.pairs", 1)
    with profile():
        pass
    sessions = T.read().counters == {}
    print(f"[flag] a second profiler session starts empty: {sessions}")
    dev = torch.device("cuda")
    _build.build_all()

    spans(1000)
    off = per_call_us(spans, OFF_CALLS)
    check = per_call_us(checks, OFF_CALLS)
    print(f"[off] span {off:.3f} us, enabled() {check:.3f} us (no profiler, {OFF_CALLS} calls)")

    with profile():
        host = per_call_us(spans, ON_CALLS)
        timed = per_call_us(lambda n: spans(n, dev), ON_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = T.read()
        read_s = time.perf_counter() - t0
        streams = per_call_us(lambda n: [torch.cuda.current_stream(dev) for _ in range(n)], ON_CALLS)
    print(f"[on] span {host:.2f} us host only, {timed:.2f} us with CUDA events (reused); read() "
          f"{read_s:.3f} s for {r.totals['jabd.detect.prepare'].count} spans; "
          f"torch.cuda.current_stream(device) {streams:.2f} us")
    with profile():
        stream = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(ON_CALLS)]
        made = time.perf_counter() - t0
        t0 = time.perf_counter()
        for ev in events:
            ev.record(stream)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for ev in events:
            ev.record(stream)
        again = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ev in events:
            ev.query()
        query = time.perf_counter() - t0
        t0 = time.perf_counter()
        for a, b in zip(events[::2], events[1::2]):
            a.elapsed_time(b)
        elapsed = time.perf_counter() - t0
    print(f"[on] a timing event: {made / ON_CALLS * 1e6:.2f} us to make, {first / ON_CALLS * 1e6:.2f} us "
          f"to record the first time (it is created then), {again / ON_CALLS * 1e6:.2f} us to record again, "
          f"{query / ON_CALLS * 1e6:.2f} us to query, {elapsed / (ON_CALLS // 2) * 1e6:.2f} us an elapsed_time")

    counted = counters_phase(dev)
    ok = hook and sessions and counted
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
