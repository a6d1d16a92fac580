"""What a run loads, checked in fresh interpreters: no JAX, no flax, not
the JAX package (top-level names compared whole, so jabd_tpu_torch is
allowed); the reference loads nothing of the served package; the harness
loads none of the repo's scripts or tests."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SCRIPTS = ("chip_smoke", "compare_kernels", "compare_train_step", "scripts", "tests", "bench")


def loaded(code: str) -> set:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_served_package():
    mods = loaded("import portbench.reference.model, portbench.reference.detect, portbench.reference.train")
    assert not mods & {"jax", "jaxlib", "flax", "jabd_tpu", "jabd_tpu_torch"}


def test_a_run_loads_no_jax_and_no_script_of_the_repo(tmp_path):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})\n"
        "import conftest\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"root = conftest.make_tiny_root(Path({str(tmp_path)!r}))\n"
        "for cell in ('tiny-flagship-detect', 'tiny-re50-train'):\n"
        "    c = harness.load_cell(cell, root)\n"
        "    assert harness.execute(c, 7, 0.2, True, time.perf_counter(), device='cpu')['correct']\n"
        "assert harness.forbidden_modules() == []\n"
    )
    mods = loaded(code)
    assert "jabd_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "jabd_tpu"}
    assert not mods & set(SCRIPTS)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jabd_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jabd_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jabd_tpu"]
