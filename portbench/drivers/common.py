"""What both drivers share: the run's outcome, the served package's model
configuration checked against the configuration file, float32 for the
reference, and the device line."""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict

import torch


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: Dict[str, float]
    device: Dict[str, Any]
    ctx: Any = None  # the per-layer readers' context, traced runs only
    extra: Dict[str, Any] = field(default_factory=dict)


def port_model_config(config: dict):
    """The served package's preset named by the configuration file, held
    to the file's numbers (a preset that drifted from the file raises, so
    the benchmark never runs another model than the file states), at the
    file's compute dtype."""
    import dataclasses

    from jabd_tpu_torch import configs as C

    port = C.get_model_config(config["preset"])
    m = config["model"]
    want = {
        "backbone": m["backbone"], "backbone_block_attention": m["backbone_block_attention"],
        "num_levels": m["num_levels"], "in_channels": tuple(m["in_channels"]),
        "out_channels": m["out_channels"], "tap_attention": m["tap_attention"],
        "fpn_attention": m["fpn_attention"], "eca_gate": m["eca_gate"],
        "fpn_upsample": m["fpn_upsample"], "fpn_variant": m["fpn_variant"],
        "anchors_per_cell": m["anchors_per_cell"], "box_loss": m["box_loss"],
        "with_iou_head": False, "tap_dropout": 0.0,
        "nlm": (m["nlm"]["ch"], tuple(m["nlm"]["psp_sizes"])) if m["nlm"] else None,
        "anchors": (tuple(map(tuple, m["anchors"]["min_sizes"])), tuple(m["anchors"]["steps"]),
                    tuple(m["anchors"]["variance"]), m["anchors"]["clip"]),
    }
    have = {k: getattr(port, k) for k in want if k not in ("nlm", "anchors")}
    have["nlm"] = (port.nlm.ch, tuple(port.nlm.psp_sizes)) if port.nlm else None
    a = port.anchors
    have["anchors"] = (tuple(map(tuple, a.min_sizes)), tuple(a.steps), tuple(a.variance), a.clip)
    diff = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if diff:
        raise ValueError(f"preset {config['preset']!r} differs from its configuration file: {diff}")
    return dataclasses.replace(port, compute_dtype=config["compute_dtype"])


@contextlib.contextmanager
def reference_precision():
    """Float32 convolutions and matrix products without TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_line(dev: torch.device) -> Dict[str, Any]:
    """platform, kind, count and the peak of allocated memory so far."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def release(dev: torch.device) -> None:
    """Free what the dropped program objects held on the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q n)-th smallest value."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s) - 1e-9) - 1, 0)]


class Phases:
    """Set-up time by phase, printed to standard error: where set-up goes."""

    def __init__(self, t_start: float, dev: torch.device):
        self.t, self.parts = t_start, []
        self.mark("start and imports")
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
            self.mark("CUDA context")

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("portbench: set-up " + ", ".join(f"{n} {s:.3f} s" for n, s in self.parts), file=sys.stderr)
