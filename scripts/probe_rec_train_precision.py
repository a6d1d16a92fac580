"""Precision probes of the PyTorch port's recognition train step on one
CUDA card: ir_101 at 112x112, AdaFace over 70,722 classes, SGD at lr 0.1,
on the seeded faces of chip_smoke.py's `[rectrain]` phase.

1. Loss curves: 15 steps on one batch of 256, float32 (TF32 off) and
   bfloat16 autocast, at dropout 0 and at dropout 0.4 under three dropout
   seeds each.
2. The first step against a float64 backbone on the card, bs 64, at
   dropout 0 and 0.4. One CUDA generator draws the mask in float32 for
   every dtype, so the three steps drop the same values.
3. One step at bs 8, dropout 0, against a float64 backbone step on the
   CPU: the card's float32 and bfloat16 steps, and the CPU's float32 step
   through oneDNN on every thread, through oneDNN on one thread, and
   through ATen's own convolutions (oneDNN off).

Errors are chip_smoke._state_errors: the worst parameter's error over
(0.05 x its change + 1e-6), the worst BatchNorm statistic's over (1e-3 x
its largest value + 1e-6), AdaFace's EMA relative error.

Run from the repository root on a machine with one card:
    python3 scripts/probe_rec_train_precision.py
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from jabd_tpu_torch.recognition import data as RD  # noqa: E402
from jabd_tpu_torch.recognition import train as RT  # noqa: E402

ARCH, BS, CLASSES, STEPS = "ir_101", 256, 70722, 15


def faces(rng, n):
    return torch.from_numpy(RD.normalize_face(C.seeded_faces(rng, n)))


def fmt(errs):
    (ratio, name, err, moved), stat, ema = errs
    return (f"worst parameter {ratio:.3e} of its bound ({name}: error {err:.3e}, change {moved:.3e}, "
            f"error / change {err / moved:.3e}); statistics {stat:.3e}; EMA {ema:.3e}")


def one_step(dev, x, y, dropout, compute_dtype="float32", float64=False, seed=0):
    state = C.rec_train_state(ARCH, "adaface", dev, dropout=dropout)
    if float64:
        state.model.double()  # the head stays float32 by design
    start = {n: p.detach().double().cpu().clone() for n, p in state.named_parameters()}
    state, m = RT.make_train_step(compute_dtype=compute_dtype, seed=seed)(state, x.to(dev), y.to(dev))
    return state, start, float(m["loss"])


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    x, y = faces(rng, BS).to(dev), torch.from_numpy(rng.integers(0, CLASSES, BS)).to(dev)

    # 1. Loss curves.
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for dropout, seeds in ((0.0, (0,)), (0.4, (0, 1, 2))):
            for seed in seeds:
                state = C.rec_train_state(ARCH, "adaface", dev, dropout=dropout)
                step = RT.make_train_step(compute_dtype=dtype, seed=seed)
                losses = []
                for _ in range(STEPS):
                    state, m = step(state, x, y)
                    losses.append(round(float(m["loss"]), 4))
                print(f"[1] {dtype} dropout {dropout} seed {seed}: losses {losses}", flush=True)
                del state
                torch.cuda.empty_cache()
    print(f"[1] {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # 2. The first step against a float64 backbone on the card, bs 64.
    t0 = time.perf_counter()
    x2, y2 = x[:64], y[:64]
    for dropout in (0.0, 0.4):
        ref, _, ref_loss = one_step(dev, x2, y2, dropout, float64=True)
        for dtype in ("float32", "bfloat16"):
            state, start, loss = one_step(dev, x2, y2, dropout, compute_dtype=dtype)
            print(f"[2] dropout {dropout} {dtype} against float64 on the card: loss {loss:.6f} / {ref_loss:.6f}; "
                  f"{fmt(C._state_errors(state, ref, start))}", flush=True)
            del state
        del ref
        torch.cuda.empty_cache()
    print(f"[2] {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # 3. bs 8 against a float64 backbone step on the CPU.
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    xb, yb = faces(rng, 8), torch.from_numpy(rng.integers(0, CLASSES, 8))
    ref, _, ref_loss = one_step(cpu, xb, yb, 0.0, float64=True)
    threads = torch.get_num_threads()
    variants = [("card float32", dict(dev=dev)), ("card bfloat16", dict(dev=dev, compute_dtype="bfloat16")),
                (f"CPU float32 oneDNN {threads} threads", dict(dev=cpu)),
                ("CPU float32 oneDNN 1 thread", dict(dev=cpu, threads=1)),
                (f"CPU float32 ATen convolutions {threads} threads", dict(dev=cpu, mkldnn=False))]
    for tag, kw in variants:
        t1 = time.perf_counter()
        torch.set_num_threads(kw.pop("threads", threads))
        with torch.backends.mkldnn.flags(enabled=kw.pop("mkldnn", True)):
            state, start, loss = one_step(kw.pop("dev"), xb, yb, 0.0, **kw)
        torch.set_num_threads(threads)
        print(f"[3] {tag} against a float64 step on the CPU: loss {loss:.6f} / {ref_loss:.6f}; "
              f"{fmt(C._state_errors(state, ref, start))} ({time.perf_counter() - t1:.1f} s)", flush=True)
        del state
    print(f"[3] {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
