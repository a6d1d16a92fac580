"""The benchmark's harness: one cell, one seed, one run, one result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything specific to a piece is a file found by name:

  BENCHMARK.json                 cells (workloads), metrics, configurations
  portbench/configs/<name>.json  a configuration: preset, model numbers,
                                 training recipe, source, reduced, assumed
  portbench/traffic/<name>.json  a traffic mix: the driver that serves it
                                 (portbench/drivers/<driver>.py) and its
                                 parameters
  portbench/limits/<cell>.json   the numbers the cell's correctness
                                 check compares, each with its limit
  portbench/metrics/<name>.py    a per-layer metric: read(ctx) -> value,
                                 or None where it finds nothing to read

A metric may be split between groups of cells so that each part has a
bound of its own: `<name>.<part>` reports what `<name>` reports (the
driver's end-to-end number; the reader `<name>.py` where `<name>.<part>.py`
does not exist).

A run exits non-zero and prints no result when there is no card (or fewer
than the cell asks for), when the served package cannot be imported, or
when JAX, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jabd_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    spec: dict
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = root / "portbench" / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, w, config, traffic, limits.get("limits", {}), spec, root)


def metrics_of(cell: Cell, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with `trace` its per-layer metrics."""
    e2e = [m for m in cell.spec["end_to_end"] if cell.name in m.get("workloads", [cell.name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in cell.spec["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def base_name(name: str, have) -> str:
    """`name`, or its longest prefix ending before a dot that `have` holds
    (a split metric's whole)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        if ".".join(parts[:n]) in have:
            return ".".join(parts[:n])
    raise KeyError(f"nothing reports the metric {name!r}")


def load_reader(root: Path, name: str) -> Callable:
    files = {p.stem for p in (root / "portbench" / "metrics").glob("*.py")}
    name = base_name(name, files)
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
            device=None, variant: Optional[str] = None, fault: Optional[Callable] = None) -> dict:
    """Run the cell once; returns the result object. `device`, `variant`
    ("fp8": the reference in float8 served in the program's place, the
    control) and `fault` (a driver's FAULTS entry, wrapped around the
    served call) are for the limits tool and the tests; a benchmark run
    passes none of them."""
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    run = driver.run(cell, seed, seconds, trace, t_start, device=device, variant=variant, fault=fault)
    # The cell's limits file names the numbers it compares; a cell without
    # one shows every reading, unlimited (and is not correct).
    names = list(cell.limits) or list(run.readings)
    values = {key: run.readings.get(key, float("nan")) for key in names}
    checks = {key: {"value": v if math.isfinite(v) else str(v), "limit": cell.limits.get(key)} for key, v in values.items()}
    correct = (run.attempted > 0 and run.failed == 0 and bool(checks)
               and all(isinstance(c["value"], float) and c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    metrics = {}
    breakdown = None
    if trace:
        for m in metrics_of(cell, True):
            value = load_reader(cell.root, m["name"])(run.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = run.ctx.trace.breakdown()
    else:
        for m in metrics_of(cell, False):
            value = run.end_to_end[base_name(m["name"], run.end_to_end)]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": run.device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
