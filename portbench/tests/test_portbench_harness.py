"""The harness on the CPU at a tiny size: cells found by files and
entries alone, the result object's keys, and `correct` against the
reference."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", ["tiny-flagship-detect", "tiny-re50-detect", "tiny-flagship-train", "tiny-re50-train"])
def test_tiny_cell_runs_and_is_correct(tiny_root, cell):
    c = harness.load_cell(cell, tiny_root)
    out = harness.execute(c, seed=2**31 + 7, seconds=0.5, trace=False, t_start=time.perf_counter(), device="cpu")
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    wanted = {m["name"] for m in harness.metrics_of(c, False)}
    assert set(out["metrics"]) == wanted and "setup_s" in wanted
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(out, allow_nan=False)
