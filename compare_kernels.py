#!/usr/bin/env python3
"""Time this checkout's CUDA kernels against another checkout's, in turns,
on one CUDA card.

    python3 compare_kernels.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of this repo, for example an
earlier commit unpacked with `git archive` into a directory git ignores.
Both checkouts' wrappers `ops.nms_cuda.nms_keep_sorted` (K1) and
`ops.matching_cuda.match_front` (K2) are loaded into this process, each
building its kernels from its own csrc/, and called on the same inputs:

- K1 on the serving path's candidates as chip_smoke.py makes them
  (jabd_flagship, bfloat16, batch 8 at 640x640, seeded weights), all
  valid and with the valid rows cut to a prefix of 50 and 500, and the
  same candidates four times over (B 32); then every other shape of
  PERF.md's K1 table: chip_smoke.nms_domain_cases (K 12,289 to 272,000),
  the serving path at pre_nms_topk = P (640 bs 8, K 16,800; 1280 bs 2,
  K 67,200) and the flagship's all-prior load at 1280 bs 8 (K 67,200);
- K2 at B 34, G 128 and the 840x840 priors, on seeded faces with the GT
  counts of chip_smoke.py's batch-34 training targets.

The two must give equal outputs. Each input is timed in turns other,
this, this, other: CUDA events around one call (median, as chip_smoke.py's
"ms") and the profiler's device time of the call's kernels.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as C

PACKAGE = "jabd_tpu_torch"


def kernel_inputs(dev):
    """{name: (call, iters)} over the inputs above, made with this
    checkout's package: call(nms, match) gives the outputs as a tuple."""
    from jabd_tpu_torch import configs
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.predict import Predictor, select_candidates

    preset = configs.get_model_config("jabd_flagship")
    pcfg = configs.PredictConfig(confidence=0.02, input_shape=(640, 640))
    p16 = Predictor(preset, C.seeded_state_dict(preset, seed=0), pcfg, device="cuda")
    batch8 = np.random.default_rng(0).normal(0, 50, (8, 640, 640, 3)).astype(np.float32)
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (640, 640)).copy()).to(dev)
    with torch.inference_mode():
        heads = p16.model(torch.from_numpy(batch8).to(dev).permute(0, 3, 1, 2))
        kb, _, kv, _ = select_candidates(*heads, anchors, pcfg, preset.anchors.variance)
    kb, kv = kb.contiguous(), kv.contiguous()
    thr, kind = pcfg.nms_iou, pcfg.nms_kind
    cases = {}
    for n in (50, 500, kv.shape[1]):
        kv_n = (kv & (torch.arange(kv.shape[1], device=dev) < n)).contiguous()
        cases[f"K1 B=8 K={kv.shape[1]} n_valid<={n}"] = (
            lambda nms, match, kv_n=kv_n: (nms(kb, kv_n, thr, kind),), 30)
    kb32, kv32 = kb.repeat(4, 1, 1).contiguous(), kv.repeat(4, 1).contiguous()
    cases[f"K1 B=32 K={kv.shape[1]}"] = (lambda nms, match: (nms(kb32, kv32, thr, kind),), 30)
    for name, boxes, valid, t, kd, _ in C.nms_domain_cases():
        boxes, valid = boxes.to(dev).contiguous(), valid.to(dev).contiguous()
        iters = 3 if valid.shape[1] == 272000 and valid.float().mean() > 0.5 else 10
        cases[f"K1 B={valid.shape[0]} {name}"] = (
            lambda nms, match, b=boxes, v=valid, t=t, kd=kd: (nms(b, v, t, kd),), iters)
    for size, bsz in ((640, 8), (1280, 2), (1280, 8)):
        anc = torch.from_numpy(A.generate_anchors(preset.anchors, (size, size)).copy()).to(dev)
        pc = configs.PredictConfig(confidence=0.02, input_shape=(size, size), pre_nms_topk=anc.shape[0])
        pred = Predictor(preset, C.seeded_state_dict(preset, seed=0), pc, device="cuda")
        x = np.random.default_rng(size + bsz).normal(0, 50, (bsz, size, size, 3)).astype(np.float32)
        with torch.inference_mode():
            heads = pred.model(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2))
            pb, _, pv, _ = select_candidates(*heads, anc, pc, preset.anchors.variance)
        pb, pv = pb.contiguous(), pv.contiguous()
        cases[f"K1 B={bsz} K={pv.shape[1]} serving at {size}, pre_nms_topk=P, {int(pv.sum())} valid"] = (
            lambda nms, match, pb=pb, pv=pv: (nms(pb, pv, thr, kind),), 10)
        del pred, heads

    priors = torch.from_numpy(A.generate_anchors(preset.anchors, (840, 840)).copy()).to(dev)
    rows = C.face_rows(np.random.default_rng(5), np.maximum(C.spread_counts(34, 128), 1))
    t = C.to_targets(batch_targets(rows, 128), dev)
    name = f"K2 B=34 G=128 P={priors.shape[0]}, {int(t.valid.sum())} valid GTs"
    cases[name] = (lambda nms, match: match(t.boxes, priors, t.valid), 50)
    return cases


def load_wrappers(root: str):
    """(nms_keep_sorted, match_front) of the package under `root`, its
    kernels built. The package's modules leave sys.modules afterwards; the
    functions keep their own."""
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from jabd_tpu_torch import _build
        from jabd_tpu_torch.ops import matching_cuda, nms_cuda
    finally:
        sys.path.remove(root)
    C.check(os.path.realpath(nms_cuda.__file__).startswith(os.path.realpath(root) + os.sep),
            f"{PACKAGE} loaded from {root}")
    for name, log in _build.build_all().items():
        C.print_ptxas(f"{root} {name}", log)

    # Not through torch.ops.jabd.nms_keep_sorted: each checkout registers
    # that one operator, and the last import would serve both.
    def nms(boxes, valid, thr=0.45, kind="iou", beta1=1.0, launch=nms_cuda._launch):
        return launch(boxes, valid, float(thr), kind, float(beta1))

    return nms, matching_cuda.match_front


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other_root = os.path.abspath(sys.argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    this = load_wrappers(here)
    cases = kernel_inputs(dev)  # with this checkout's package, before the other loads
    other = load_wrappers(other_root)
    for name, (call, iters) in cases.items():
        got, want = call(*this), call(*other)
        torch.cuda.synchronize()
        C.check(all(torch.equal(x, y) for x, y in zip(got, want)), f"{name}: this checkout == {other_root}")
        fns = [lambda f=f: call(*f) for f in (other, this, this, other)]
        events = [C.cuda_ms(fn, iters) for fn in fns]
        device = [C.device_ms(fn) for fn in fns]
        ratio = min(events[1:3]) / min(events[0], events[3])
        text = " / ".join(f"{ms:.4f}" for ms in events)
        if None in device:
            dtext = "device not measured"
        else:
            dtext = (" / ".join(f"{ms:.4f}" for ms in device)
                     + f" ms, this/other {min(device[1:3]) / min(device[0], device[3]):.3f}")
        print(f"[compare] {name}: equal outputs; other/this/this/other events {text} ms, "
              f"this/other {ratio:.3f}; device {dtext}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
