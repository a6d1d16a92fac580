"""The readings that a cell's limits are set from (portbench/limits/<cell>.json).

    python3 portbench/limits.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--faults 7,8,9] [--fault-names a,b] [--seconds 2]

For each seed it runs the cell as a benchmark run does, with a short
window, and prints the numbers its correctness check compares
(`checks`), one JSON line each:

  program   the served package as configured (the lower readings);
  control   the nearest lower precision in the program's place: the
            reference computed in float8 (reference/model.py::set_fp8),
            served through the driver (`variant="fp8"`);
  fault:<f> the served call broken underneath (drivers' FAULTS).

Benchmark runs never run this; it is the record behind each limit, kept
beside the harness so that the readings can be taken again. Lines are
also appended to chiprun_out/limits-<cell>.jsonl when that directory is
writable.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def readings(cell, seed: int, kind: str, seconds: float, device=None) -> dict:
    """The compared numbers of one run of `kind` ('program', 'control' or
    'fault:<name>'), and beside them (under 'diagnostics') what the
    driver adds."""
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    variant = "fp8" if kind == "control" else None
    fault = driver.FAULTS[kind.split(":", 1)[1]] if kind.startswith("fault:") else None
    run = driver.run(cell, seed, seconds, False, time.perf_counter(), device=device, variant=variant, fault=fault)
    return {**run.readings, "diagnostics": run.extra}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-names", default="", help="which of the driver's FAULTS (default: all)")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [("program", s) for s in seeds(args.seeds)] + [("control", s) for s in seeds(args.control)]
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    names = [f for f in args.fault_names.split(",") if f] or list(driver.FAULTS)
    jobs += [(f"fault:{f}", s) for f in names for s in seeds(args.faults)]
    out_dir = Path("chiprun_out")
    for kind, seed in jobs:
        t0 = time.perf_counter()
        try:
            got = readings(cell, seed, kind, args.seconds)
        except Exception as e:  # a run that fails is a reading too: record it and go on
            got = {"error": f"{type(e).__name__}: {e}"}
        line = {"workload": cell.name, "kind": kind, "seed": seed, "readings": got, "s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out_dir.is_dir():
            with open(out_dir / f"limits-{cell.name}.jsonl", "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
