"""A run with the timed path broken underneath comes out not correct, and
so does the lower-precision control: the benchmark's comparison can fail.
Tiny cells on the CPU, the harness's look for a card skipped."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.drivers import detect as DD
from portbench.drivers import train as DT


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell,fault", [("tiny-flagship-detect", f) for f in DD.FAULTS]
                         + [("tiny-flagship-train", f) for f in DT.FAULTS])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    c = harness.load_cell(cell, tiny_root)
    driver = DD if c.traffic["driver"] == "detect" else DT
    out = harness.execute(c, 41, 0.3, False, time.perf_counter(), device="cpu", fault=driver.FAULTS[fault])
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny-flagship-detect", "tiny-flagship-train"])
def test_the_lower_precision_control_is_not_correct(tiny_root, cell):
    c = harness.load_cell(cell, tiny_root)
    out = harness.execute(c, 43, 0.3, False, time.perf_counter(), device="cpu", variant="fp8")
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]
