#!/usr/bin/env python3
"""Time this checkout's bf16 train step against another checkout's, in
turns, on one CUDA card.

    python3 compare_train_step.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of this repo, for example an
earlier commit unpacked with `git archive` into a directory git ignores.
Each turn is a process of its own that imports one checkout's
`jabd_tpu_torch` and runs its plain train step: jabd_flagship (bf16
compute, float32 parameters) at 840x840, batch 34, from the reference's
seeded init, on the batch-34 synthetic images and targets of
chip_smoke.py's `[train]` phase. The turns run other, this, this, other;
each prints one `[compare]` line: back-to-back ms/step (CUDA events
around 20 steps after 3 warm-up steps), device busy ms/step (the
profiler's kernel time over 5 steps), peak memory and the first loss.
The first losses must be equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def run(root: str) -> dict:
    """One turn: the train step of the package under `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as C
    from jabd_tpu_torch import configs
    from jabd_tpu_torch import train as T
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.ops import anchors as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    preset = configs.get_model_config("jabd_flagship")
    tcfg = configs.TrainConfig()
    size, bsz, g = tcfg.image_size, tcfg.batch_size, tcfg.max_targets
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (size, size)).copy()).to(dev)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.normal(0, 50, (bsz, size, size, 3)).astype(np.float32)).to(dev)
    targets = C.to_targets(batch_targets(C.face_rows(rng, np.maximum(C.spread_counts(bsz, g), 1)), g), dev)
    state = T.create_train_state(preset, tcfg, 1, device=dev)
    step = T.make_train_step(preset, tcfg)
    loss = float(step(state, images, targets, anchors)[1]["loss"])
    torch.cuda.reset_peak_memory_stats()
    ms = C.back_to_back_ms(lambda: step(state, images, targets, anchors), iters=20, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = C.device_ms(lambda: step(state, images, targets, anchors), iters=5)
    return {"root": root, "ms": ms, "device_ms": busy, "peak_gib": peak, "first_loss": loss,
            "package": os.path.dirname(T.__file__)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(run(sys.argv[2])))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_train_step: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[1])
    losses = {}
    for tag, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", root],
                             check=True, capture_output=True, text=True, cwd=here)
        r = json.loads(out.stdout.strip().splitlines()[-1])
        losses.setdefault(tag, []).append(r["first_loss"])
        busy = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        print(f"[compare] train step bf16 bs34 840x840 {tag} ({r['package']}): back-to-back "
              f"{r['ms']:.3f} ms/step, device busy {busy}/step, peak memory {r['peak_gib']:.2f} GiB, "
              f"first loss {r['first_loss']:.6f} [{card}]")
    if len(set(losses["this"] + losses["other"])) != 1:
        print(f"compare_train_step: first losses differ {losses}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
