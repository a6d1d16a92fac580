"""The recognition training cell's driver on the CPU at a tiny size (IR-18
at 112x112, bs 4, AdaFace over 1,000 classes, float32): the program is
correct against the reference, and every planted fault and the float8
control move a reading past its limit. Also the FLOPs that `mfu.rectrain`
counts at the cell's full size."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.drivers import rectrain as DR

REPO = Path(__file__).resolve().parents[2]

TINY_TRAFFIC = {"driver": "rectrain", "why": "tiny", "batch": 4, "image_size": 112, "pool_batches": 3}
# The tiny cell serves in float32 against the float32 reference. Seeds 41-43
# read at most 2.2e-7 (loss), 1e-7 (median gradient), 2e-3 (worst update),
# 1e-7 (median statistic), 8e-7 (median momentum) and 0 (EMA); a fault
# moves its reading to 1.0 (state unchanged, statistics, kernel, EMA
# frozen) or by orders of magnitude (half the batch), the altered loss to
# 0.05, and the float8 control the gradients by ~0.07.
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap_median": 1e-3, "update_gap_worst": 0.02, "stats_gap_median": 1e-3,
               "momentum_gap_median": 1e-3, "ema_gap": 1e-3}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """A copy of BENCHMARK.json and portbench/ with the tiny cell
    `tiny-rectrain` added by files and entries alone."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((root / "portbench" / "configs" / "ir_101_adaface.json").read_text())
    config.update(name="tiny_ir_18", preset="ir_18", compute_dtype="float32")
    config["model"]["stages"] = [[64, 2], [128, 2], [256, 2], [512, 2]]
    config["head"]["class_num"] = 1000
    (root / "portbench" / "configs" / "tiny_ir_18.json").write_text(json.dumps(config))
    (root / "portbench" / "traffic" / "tiny-rectrain.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "portbench" / "limits" / "tiny-rectrain.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_ir_18", "source": "tiny", "file": "portbench/configs/tiny_ir_18.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": "tiny-rectrain", "config": "tiny_ir_18", "traffic": "tiny-rectrain", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ir_101-train-adaface" in m.get("workloads", ()):
            m["workloads"].append("tiny-rectrain")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.load_cell("tiny-rectrain", root)


def test_the_tiny_cell_is_correct(tiny_cell):
    out = harness.execute(tiny_cell, 2**31 + 7, 0.3, False, time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault", list(DR.FAULTS))
def test_a_planted_fault_is_not_correct(tiny_cell, fault):
    out = harness.execute(tiny_cell, 41, 0.3, False, time.perf_counter(), device="cpu", fault=DR.FAULTS[fault])
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


def test_the_float8_control_is_not_correct(tiny_cell):
    out = harness.execute(tiny_cell, 43, 0.3, False, time.perf_counter(), device="cpu", variant="fp8")
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


def test_a_traced_run_reports_only_what_it_finds(tiny_cell):
    """On the CPU no kernel runs on a card and the spans time no stream:
    the seven readers find nothing, and the line leaves them out."""
    names = [m["name"] for m in harness.metrics_of(tiny_cell, True)]
    assert sorted(names) == sorted(f"{n}.rectrain" for n in ("forward_ms", "head_ms", "backward_ms", "optimizer_ms",
                                                              "device_idle", "kernels_per_step", "mfu"))
    out = harness.execute(tiny_cell, 5, 0.2, True, time.perf_counter(), device="cpu")
    assert out["correct"] and out["metrics"] == {}


def test_the_full_cell_counts_the_issues_flops():
    """IR-101 at 112x112: 72.4 GFLOP an image forward and backward
    (torch's FlopCounterMode), plus the head's 3 x 2 x 256 x 512 x 205,990."""
    cell = harness.load_cell("ir_101-train-adaface", REPO)
    ctx = DR.Context(None, [0, 1], cell)
    flops = ctx.flops_per_step()
    head = 6 * 256 * 512 * 205990
    assert flops - head == 256 * 72_417_214_464
    assert ctx.calls == 2 and ctx.images == 512
