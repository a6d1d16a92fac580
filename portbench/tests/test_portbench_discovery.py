"""Pieces found by name: a per-layer metric added as a file and an entry
alone is read in a traced run; one whose reader finds nothing is left out
of the line; the command refuses to run without a card or without the
served package."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]


def test_a_metric_added_by_a_file_and_an_entry_is_read(tiny_root):
    metrics = tiny_root / "portbench" / "metrics"
    (metrics / "calls.detect.py").write_text("def read(ctx):\n    return float(ctx.calls)\n")
    (metrics / "nothing.detect.py").write_text("def read(ctx):\n    return None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for name in ("calls.detect", "nothing.detect"):
        spec["per_layer"].append({"name": name, "unit": "calls", "better": "higher", "source": "program_counter",
                                  "layer": "device", "moves": "detect_img_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny-flagship-detect", tiny_root)
    names = [m["name"] for m in harness.metrics_of(cell, True)]
    assert "calls.detect" in names and "nothing.detect" in names and "mfu.train" not in names
    torch.set_num_threads(2)
    out = harness.execute(cell, 3, 0.2, True, time.perf_counter(), device="cpu")
    assert out["metrics"]["calls.detect"] == {"value": float(out["attempted"]), "unit": "calls"}
    assert "nothing.detect" not in out["metrics"]
    assert out["correct"] and set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def run_command(cwd: Path, workload: str):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_exits_without_a_result_where_it_cannot_run(tmp_path):
    if not torch.cuda.is_available():
        out = run_command(REPO, "flagship-train-840")
        assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", bare)
    shutil.copytree(REPO / "portbench", bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_command(bare, "flagship-train-840")
    assert out.returncode != 0 and out.stdout == ""


def test_a_metric_split_off_by_an_entry_alone_reports_its_whole(tiny_root):
    (tiny_root / "portbench" / "metrics" / "calls.detect.py").write_text("def read(ctx):\n    return float(ctx.calls)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "detect_img_per_s.tiny", "unit": "img/s", "better": "higher", "bound": 0.1,
                               "source": "host_clock", "workloads": ["tiny-flagship-detect"]})
    spec["per_layer"].append({"name": "calls.detect.tiny", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "detect_img_per_s.tiny",
                              "workloads": ["tiny-flagship-detect"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny-flagship-detect", tiny_root)
    torch.set_num_threads(2)
    out = harness.execute(cell, 5, 0.2, False, time.perf_counter(), device="cpu")
    assert out["metrics"]["detect_img_per_s.tiny"] == out["metrics"]["detect_img_per_s"]
    traced = harness.execute(cell, 5, 0.2, True, time.perf_counter(), device="cpu")
    assert traced["metrics"]["calls.detect.tiny"] == {"value": float(traced["attempted"]), "unit": "calls"}
    assert harness.base_name("mfu.train.re50", {"mfu.train", "mfu"}) == "mfu.train"
