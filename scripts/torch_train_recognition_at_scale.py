"""Recognition train at scale with the PyTorch port: the production
`recognition.train.fit` twice with a simulated interrupt and auto-resume,
the best-on-val copy, metrics.csv and held-out 10-fold verification.

The twin of scripts/train_recognition_at_scale.py on `jabd_tpu_torch`,
over a synthetic identity tree (32 identities x 24 PIL-written JPEGs by
default) and a held-out pair bundle in the production memfile layout
(`recognition/data.py::load_five_validation_sets` reads it as a partial
`lfw` set): ir_18 under bf16 autocast, the AdaFace head, SGD lr 0.05 with
milestones at 2/3 and 9/10 of the whole run. Phase A stops at epochs //
2; phase B, a fresh state and `fit` call with the full budget, must
resume from phase A's checkpoint (its SGD momentum included): its log
names the resume, holds only the later epochs, `state.step` is exact and
metrics.csv has a row per epoch. Then final train accuracy > 0.85 and the
best val_acc > 0.9 (`best_meta.json`), the JAX script's criteria. Runs of
4 epochs or fewer check the plumbing, not the learning.

`--device-augment` trains through `device_face_train_loader` and the
augmented step; `--shard-head` builds the step of
`recognition/parallel.py` over the process mesh (world size 1 when
started alone: the class-sharded step then is the plain one). Neither
CUDA kernel lies on this path.

    python scripts/torch_train_recognition_at_scale.py [--epochs 40] \\
        [--device-augment] [--shard-head] [--device cpu]

On the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from scripts import _torch_synthetic as syn

IDS, PER_ID = 32, 24


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--arch", default="ir_18")
    ap.add_argument("--device-augment", action="store_true")
    ap.add_argument("--shard-head", action="store_true")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--ids", type=int, default=IDS)
    ap.add_argument("--per-id", type=int, default=PER_ID)
    ap.add_argument("--val-pairs", type=int, default=120)
    ap.add_argument("--root", default="",
                    help="artifact directory, reusable: a killed run resumes from its checkpoints")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap


def build_data(root: str, ids: int, per_id: int, val_pairs: int):
    """The identity tree under root/train and the pair bundle under
    root/val (seed 0, the tree first), unless the bundle is there."""
    rng = np.random.default_rng(0)
    if not os.path.exists(os.path.join(root, "val", "lfw_list.npy")):
        bases = syn.build_identity_tree(os.path.join(root, "train"), rng, ids, per_id)
        syn.build_val_bundle(os.path.join(root, "val"), bases, rng, pairs=val_pairs)


def new_state(arch: str, classes: int, steps_per_epoch: int, epochs: int, dev, pad_to: int = 0):
    """A fresh backbone (seeded 0) and AdaFace head with the recipe's SGD
    state: lr 0.05, milestones at 2/3 and 9/10 of `epochs`."""
    from jabd_tpu_torch.recognition import build_head, build_model
    from jabd_tpu_torch.recognition import train as RT

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(arch, device="cpu")
    model = model.to(dev)
    head = build_head("adaface", class_num=classes, pad_to=pad_to, seed=0, device=dev)
    return RT.create_state(
        model, head, num_train_steps_hint=steps_per_epoch * epochs, lr=0.05,
        milestones=(steps_per_epoch * epochs * 2 // 3, steps_per_epoch * epochs * 9 // 10),
    )


def main(argv=None) -> dict:
    from jabd_tpu_torch import resolve_device
    from jabd_tpu_torch.parallel import mesh as M
    from jabd_tpu_torch.recognition import train as RT
    from jabd_tpu_torch.recognition.data import ImageFolderDataset

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="scale_rec_")
    print(json.dumps({"artifact_root": root}), flush=True)
    build_data(root, args.ids, args.per_id, args.val_pairs)
    ds = ImageFolderDataset(os.path.join(root, "train"))
    ckdir = os.path.join(root, "ck")
    val_dir = os.path.join(root, "val")

    steps_per_epoch = len(ds) // args.batch
    total, mid = args.epochs, args.epochs // 2
    print(json.dumps({
        "images": len(ds), "classes": ds.num_classes, "steps_per_epoch": steps_per_epoch,
        "epochs": total, "interrupt_at": mid,
    }), flush=True)

    mesh = None
    if args.shard_head:
        # The process group torchrun describes; alone, a mesh of size 1.
        M.init_distributed(backend="gloo" if dev.type == "cpu" else None)
        mesh = M.process_mesh(dev)

    def setup():
        state = new_state(args.arch, ds.num_classes, steps_per_epoch, total, dev,
                          pad_to=mesh.size if mesh is not None else 0)
        if mesh is not None:
            from jabd_tpu_torch.recognition import parallel as RP

            maker = RP.make_sharded_train_step_aug if args.device_augment else RP.make_sharded_train_step
            return maker(state, mesh, compute_dtype="bfloat16", seed=0)
        maker = RT.make_train_step_aug if args.device_augment else RT.make_train_step
        return maker(compute_dtype="bfloat16", seed=0), state

    def run(epochs, log):
        step, state = setup()
        return RT.fit(state, step, ds, args.batch, epochs, device_augment=args.device_augment, seed=0,
                      val_dir=val_dir, checkpoint_dir=ckdir, log=log, device=dev, mesh=mesh)

    logs_a, logs_b = [], []

    def logger(into):
        def log(m):
            into.append(str(m))
            print(m, flush=True)
        return log

    # Phase A: to the midpoint, then stop (an interrupt at an epoch
    # boundary; the checkpoint there carries the SGD momentum).
    t0 = time.time()
    run(mid, logger(logs_a))
    print(f"phase A done: {mid} epochs in {time.time() - t0:.0f}s", flush=True)

    # Phase B: a fresh state and fit call with the full budget must resume.
    t0 = time.time()
    state = run(total, logger(logs_b))
    t_b = time.time() - t0
    print(f"phase B done in {t_b:.0f}s, state.step={state.step}", flush=True)

    assert any(f"resumed from checkpoint at epoch {mid}" in m for m in logs_b), "phase B did not auto-resume"
    b_epochs = sum("loss=" in m for m in logs_b)
    assert b_epochs == total - mid, ("resume restarted?", b_epochs)
    assert state.step == steps_per_epoch * total, (state.step, steps_per_epoch * total)

    with open(os.path.join(ckdir, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == total + 1, ("metrics.csv rows", len(rows))
    last = rows[-1].split(",")
    final_acc, final_val = float(last[3]), float(last[4])
    with open(os.path.join(ckdir, "best_meta.json")) as f:
        best = json.load(f)
    b_steps = (total - mid) * steps_per_epoch
    print(json.dumps({
        "final_train_acc": final_acc,
        "final_val_acc": final_val,
        "best": best,
        "e2e_img_per_sec_phaseB": round(b_steps * args.batch / t_b, 1),
        "steps_per_sec_phaseB": round(b_steps / t_b, 3),
    }), flush=True)
    print(json.dumps({"epoch_rows": rows[1:]}), flush=True)
    smoke = args.epochs <= 4  # tiny runs check plumbing, not learning
    # Train accuracy is measured on augmented samples through the margin
    # logits (AdaFace suppresses the target logit by design), so it
    # plateaus below 1; the learning proof is the held-out verification.
    assert smoke or final_acc > 0.85, f"train acc {final_acc}"
    assert smoke or best["val_acc"] > 0.9, f"held-out val_acc {best}"

    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    print("train_recognition_at_scale PASSED", flush=True)
    return {"root": root, "state_step": state.step, "b_epochs": b_epochs, "rows": rows,
            "final_acc": final_acc, "final_val": final_val, "best": best}


if __name__ == "__main__":
    main()
