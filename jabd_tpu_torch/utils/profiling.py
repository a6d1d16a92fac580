"""Profiling and capacity reporting.

Port of `jabd_tpu/utils/profiling.py` (`count_params`, `flops_of`,
`per_layer_table`, `benchmark`, `trace`). The JAX package reads FLOPs from
XLA's cost analysis of the compiled graph; here they come from
`torch.utils.flop_counter.FlopCounterMode`, which counts convolutions and
matrix products only (2 per multiply-add). XLA also counts elementwise
work and lowers the bicubic resize to matmuls, so the two packages' GFLOPs
for one model differ; parameter counts are equal. Times come from CUDA
events on the card (`benchmark`) and traces from `torch.profiler`
(`trace`). The JAX module's `per_layer_table_subprocess` and
`chained_benchmark` work around its remote TPU and have no counterpart.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    """Number of parameters (BatchNorm statistics are buffers, not counted,
    as the JAX package counts the `params` collection only)."""
    return sum(p.numel() for p in model.parameters())


def flops_of(fn: Callable, *args) -> int:
    """Convolution and matmul FLOPs of one call `fn(*args)` (2 per
    multiply-add), counted under FlopCounterMode without gradients."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return int(counter.get_total_flops())


def per_layer_table(
    model: torch.nn.Module,
    x: torch.Tensor,
    total_params: Optional[int] = None,
    total_flops: Optional[int] = None,
) -> list:
    """Rows {"module", "params", "flops", "gflops"}, one per top-level
    child of `model` (FLOPs of one forward of `x`), then an "(other)" row
    holding what no child holds and a "TOTAL" row, so that the rows above
    TOTAL sum to it (the role of fvcore's `flop_count_table` in the
    reference's count_param.py:388-395). The totals default to the model's
    own parameter count and the forward's FLOPs."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    counts = counter.get_flop_counts()
    root = type(model).__name__
    rows = []
    for name, child in model.named_children():
        flops = int(sum(counts.get(f"{root}.{name}", {}).values()))
        rows.append({"module": name, "params": count_params(child), "flops": flops})
    total_params = count_params(model) if total_params is None else int(total_params)
    total_flops = int(counter.get_total_flops()) if total_flops is None else int(total_flops)
    rows.append({
        "module": "(other)",
        "params": total_params - sum(r["params"] for r in rows),
        "flops": total_flops - sum(r["flops"] for r in rows),
    })
    rows.append({"module": "TOTAL", "params": total_params, "flops": total_flops})
    for r in rows:
        r["gflops"] = round(r["flops"] / 1e9, 4)
    return rows


def benchmark(fn: Callable, *args, iters: int = 50, warmup: int = 5) -> Dict[str, float]:
    """Seconds per call of `fn(*args)` on the card: a CUDA event pair
    around each of `iters` calls after `warmup` calls, read after one
    synchronize. Returns mean, median, p90 and best. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark times the card with CUDA events; there is no CUDA device")
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    arr = np.asarray([s.elapsed_time(e) / 1000.0 for s, e in pairs])
    return {
        "mean_s": float(arr.mean()),
        "median_s": float(np.median(arr)),
        "p90_s": float(np.percentile(arr, 90)),
        "best_s": float(arr.min()),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the card too, where there is one);
    writes `<log_dir>/trace.json` (chrome://tracing, Perfetto) and yields
    the profiler, whose `key_averages()` sums time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
