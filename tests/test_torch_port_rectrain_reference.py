"""PyTorch port, the AdaFace training step against the benchmark's plain
reference (portbench/reference/recognition.py) on the CPU:

- IR-101's forward at 112x112, bs 4, in train and eval mode, against
  `recognition.IRBackbone` on one seeded state dict;
- the AdaFace head's logits and norm EMA against `AdaFaceHead` at 1,000
  classes;
- one and three steps of `make_train_step(compute_dtype="float32")`
  against the reference's SGD steps with dropout 0.4 on the same masks:
  the loss, every parameter's update, the BatchNorms' running statistics,
  the momentum buffers and the head's EMA; a step with the backbone in
  bfloat16 fails at least one of those tolerances;
- the reference imports neither JAX nor either package, in a fresh
  interpreter.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jabd_tpu_torch.recognition import build_model
from jabd_tpu_torch.recognition import heads as H
from jabd_tpu_torch.recognition import train as RT
from portbench import generators as G
from portbench.drivers import rectrain as DR
from portbench.reference import recognition as RR
from tests._torch_port_steps import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CLASSES = 1000
IR18 = [[64, 2], [128, 2], [256, 2], [512, 2]]

# Tolerances, each with its reason. Port and reference compute the same
# float32 operations in other orders and other kernels (F.prelu against a
# where, torch's batch_norm with its running-variance correction against
# an explicit one, the margin on the target column against the one-hot
# over every column), so they part by float32 rounding alone:
# - the forward through IR-101's 49 units: rounding compounds to ~1e-6 of
#   the embedding; 1e-4 relative, 1e-5 absolute on unit-norm entries;
FORWARD = dict(rtol=1e-4, atol=1e-5)
# - the head: cosines part by ~1e-7, times s = 64 on the logits; the EMA
#   buffers are one multiply-add of equal statistics;
LOGITS = dict(rtol=1e-5, atol=1e-4)
EMA = dict(rtol=1e-6, atol=1e-6)
# - the steps, per leaf the norm of the difference over the larger of the
#   reference leaf's norm and the median leaf's (the benchmark's
#   normalization: leaves whose gradient is nought to rounding, the shifts
#   every train-mode BatchNorm removes, are held to the median), the worst
#   leaf: at bs 8 float32 reads up to ~2e-5 after one step and ~1.5e-3
#   after three (lr 0.1 at 8 images a batch amplifies rounding from step
#   to step, most in the BatchNorm scales), a bfloat16 backbone (8 bits of
#   mantissa) 0.12 after one; the running statistics read ~1e-4 against
#   bfloat16's 1.6e-2;
STEP_LEAF = 2e-2
STATS_LEAF = 3e-3
# - the loss (~37 at the first step: AdaFace's margin of 0.4 on s = 64):
#   float32 rounding, ~1e-6 relative; bfloat16 moves it by ~4e-4.
LOSS = 1e-4


def config(stages=None, classes=CLASSES):
    cfg = json.loads((ROOT / "portbench" / "configs" / "ir_101_adaface.json").read_text())
    if stages is not None:
        cfg["model"]["stages"] = stages
    cfg["head"]["class_num"] = classes
    return cfg


def faces(seed, n, size=112):
    gen = torch.Generator().manual_seed(seed)
    images = G.smooth_images(gen, n, size, size, "cpu").float() / 127.5 - 1.0
    labels = torch.randint(0, CLASSES, (n,), generator=gen)
    return images, labels


def test_ir101_forward_equals_the_served_backbone():
    cfg = config()
    p0 = DR.seeded_state(cfg, 3, "cpu")
    ref, _ = RR.build(cfg)
    RR.load(ref, RR.AdaFace(CLASSES, 512, 0.4, 0.333, 64.0, 0.01, 1e-3), p0)
    images, _ = faces(4, 4)
    x = images.permute(0, 3, 1, 2)
    G.calibrate_batchnorms(ref, x)  # eval mode then normalizes what reaches each BatchNorm
    port = build_model("ir_101", device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    for train in (True, False):
        ref.train(train)
        port.train(train)
        with torch.no_grad():  # train mode: dropout 0.4 on the same masks
            e_ref, n_ref = ref(x, generator=torch.Generator().manual_seed(7))
            e_port, n_port = port(x, generator=torch.Generator().manual_seed(7))
        torch.testing.assert_close(e_port, e_ref, **FORWARD)
        torch.testing.assert_close(n_port, n_ref, rtol=FORWARD["rtol"], atol=0.0)
        assert torch.isfinite(n_ref).all() and float(n_ref.min()) > 1.0
    assert port.features_bn.running_var.ne(1.0).any()  # train mode moved the running statistics


def test_adaface_head_equals_the_served_head():
    gen = torch.Generator().manual_seed(5)
    port = H.build_head("adaface", class_num=CLASSES, device="cpu").train()
    ref = RR.AdaFace(CLASSES, 512, 0.4, 0.333, 64.0, 0.01, 1e-3).train()
    ref.load_state_dict(port.state_dict())
    for _ in range(2):  # the second call reads the EMA the first one moved
        emb = torch.nn.functional.normalize(torch.randn(16, 512, generator=gen), dim=1)
        norms = 5.0 + 30.0 * torch.rand(16, 1, generator=gen)
        labels = torch.randint(0, CLASSES, (16,), generator=gen)
        torch.testing.assert_close(port(emb, norms, labels), ref(emb, norms, labels), **LOGITS)
        for name in ("batch_mean", "batch_std"):
            torch.testing.assert_close(getattr(port, name), getattr(ref, name), **EMA)
    assert abs(float(ref.batch_std) - 100.0) > 1.0  # two EMA updates at t_alpha 0.01 of a std far below 100


def served_steps(cfg, p0, batches, seed, compute_dtype):
    """The port's steps through `create_state` / `make_train_step` from
    the combined state dict p0: losses, the momentum buffers after the
    first step, and the state after the last (`RR.snapshot`)."""
    model = build_model("ir_18", device="cpu")
    head = H.build_head("adaface", class_num=CLASSES, device="cpu")
    RR.load(model, head, p0)
    state = RT.create_state(model, head, num_train_steps_hint=1 << 40, lr=cfg["optimizer"]["lr"])
    step = RT.make_train_step(compute_dtype=compute_dtype, seed=seed)
    losses = []

    def momentum():
        return {n: state.optimizer.state[p]["momentum_buffer"].clone()
                for n, p in RR.named_parameters(state.model, state.head).items()}

    for images, labels in batches:
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))
        if len(losses) == 1:
            grad1 = momentum()
    return losses, grad1, RR.snapshot(state.model, state.head, momentum())


def leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf ||got - want|| over max(||want||, the median leaf norm)."""
    norms = {n: float(want[n].double().norm()) for n in want}
    med = statistics.median(norms.values())
    return {n: float((got[n].double() - want[n].double()).norm()) / max(norms[n], med) for n in want}


def step_gaps(cfg, p0, batches, seed, compute_dtype):
    losses, grad1, after = served_steps(cfg, p0, batches, seed, compute_dtype)
    ref = RR.reference_steps(cfg, p0, batches, "cpu", seed)
    r = ref["after"]

    def change(state, key):
        return {n: state[key][n] - p0[n] for n in r[key]}

    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "first gradient": max(leaf_gaps(grad1, ref["grad1"]).values()),
        "update": max(leaf_gaps(change(after, "params"), change(r, "params")).values()),
        "running statistics": max(leaf_gaps(change(after, "stats"), change(r, "stats")).values()),
        "momentum": max(leaf_gaps(after["momentum"], r["momentum"]).values()),
        "ema": max(abs(float(after["ema"][n]) - float(r["ema"][n])) for n in ("batch_mean", "batch_std")),
    }


WITHIN = {"loss": LOSS, "first gradient": STEP_LEAF, "update": STEP_LEAF, "running statistics": STATS_LEAF,
          "momentum": STEP_LEAF, "ema": EMA["atol"] + EMA["rtol"] * 100.0}


@pytest.fixture(scope="module")
def steps_setup():
    cfg = config(IR18)
    p0 = DR.seeded_state(cfg, 11, "cpu")
    batches = [faces(20 + i, 8) for i in range(3)]
    return cfg, p0, batches


@pytest.mark.parametrize("steps", [1, 3])
def test_float32_steps_equal_the_reference(steps_setup, steps):
    cfg, p0, batches = steps_setup
    assert cfg["model"]["dropout"] == 0.4
    gaps = step_gaps(cfg, p0, batches[:steps], 2**31 + 9, "float32")
    assert all(np.isfinite(v) for v in gaps.values()), gaps
    over = {k: v for k, v in gaps.items() if v > WITHIN[k]}
    assert not over, (over, gaps)


def test_a_bfloat16_backbone_fails_the_tolerances(steps_setup):
    cfg, p0, batches = steps_setup
    gaps = step_gaps(cfg, p0, batches[:1], 2**31 + 9, "bfloat16")
    assert any(v > WITHIN[k] for k, v in gaps.items()), gaps


def test_the_reference_imports_neither_jax_nor_either_package():
    probe = ("import json, sys\nimport portbench.reference.recognition\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "jabd_tpu", "jabd_tpu_torch"}
