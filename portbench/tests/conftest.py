"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
two tiny cells added by files and entries alone, and the `card` marker
for tests that need the card (they decide inside the test and skip on a
machine without one)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_DETECT = {
    "driver": "detect", "why": "tiny", "image_width": 128, "aspects": [[4, 3], [3, 2], [16, 9], [3, 4]],
    "per_aspect": 1, "pool_batches": 2, "input_size": [128, 128], "confidence": 0.02, "pre_nms_topk": "all",
    "nms_iou": 0.3, "nms_kind": "iou", "max_detections": 40, "calibration_images": 4, "warmup_calls": 1,
    "check_batches": 2,
}
TINY_TRAIN = {
    "driver": "train", "why": "tiny", "batch": 4, "image_size": 128, "max_targets": 8, "pool_batches": 3,
    "source_width": 256, "faces_per_image": 3.0, "face_px": [10.0, 200.0], "landmark_share": 0.7,
    "calibration_images": 4,
}


# On the CPU the tiny cells serve in float32 against the reference's plain
# bfloat16: detection read 0-1 (nms_rules) on four seeds, float8 5 and up.
# Training (seeds 41-43) read up to 0 (loss), 4.2e-8 (median gradient),
# 4.7e-4 (worst update), 2.5e-4 (worst BatchNorm statistic) and 5.8e-6
# (median Adam moment); the float8 control (seeds 44, 45) 8.5e-4 to 1.2e-3,
# 0.043 to 0.052, 0.09 to 0.12, 4.0 and 0.031 to 0.046.
DETECT_LIMITS = {"nms_rules": 5.0}
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap_median": 1e-3, "update_gap_worst": 0.02, "stats_gap_worst": 0.02,
                "adam_gap_median": 0.01}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def add_cell(root: Path, name: str, config: str, traffic: str, body: dict, limits: dict, like: str) -> None:
    """A cell added the way a later change adds one: a traffic file, a
    limits file and a workloads entry, reporting the metrics that the cell
    `like` reports."""
    (root / "portbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
    (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps({"limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with two float32 copies of
    the configurations and the tiny cells tiny-flagship-detect,
    tiny-re50-detect, tiny-flagship-train and tiny-re50-train."""
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for model, config in (("flagship", "jabd_flagship"), ("re50", "re50_eca_nonlocal")):
        body = json.loads((root / "portbench" / "configs" / f"{config}.json").read_text())
        body.update(name=f"tiny_{config}", compute_dtype="float32")
        file = f"portbench/configs/tiny_{config}.json"
        (root / file).write_text(json.dumps(body))
        spec["configs"].append({"name": f"tiny_{config}", "source": "tiny", "file": file, "reduced": [], "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for model, config in (("flagship", "tiny_jabd_flagship"), ("re50", "tiny_re50_eca_nonlocal")):
        add_cell(root, f"tiny-{model}-detect", config, "tiny-detect", TINY_DETECT, DETECT_LIMITS,
                 "flagship-detect-1280-allpriors")
        add_cell(root, f"tiny-{model}-train", config, "tiny-train", TINY_TRAIN, TRAIN_LIMITS, f"{model}-train-840")
    return root
