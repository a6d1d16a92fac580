"""Train at scale with the PyTorch port: the production `train.fit` twice
with a simulated interrupt and auto-resume, then held-out WIDER AP.

The twin of scripts/train_at_scale.py on `jabd_tpu_torch`, over a
synthetic WIDER tree (bright squares as faces, 1,344 JPEGs by default):

* `train.fit` through the device-augment path (host decode and plans,
  `prefetch_to_device`, resample and HSV on the device, K2 in every step
  on the card) with `utils/checkpoint.CheckpointManager` checkpoints;
* phase A stops at total_epochs // 2 (an interrupt at an epoch
  boundary); phase B is a fresh `fit` call with the full budget that must
  resume from phase A's checkpoint with its Adam moments: `state.step`
  must be exact and phase B's own loss log (the newest
  `loss_<ts>/epoch_loss.txt`) must hold only the epochs after the
  interrupt;
* the loss curve over both phases must halve;
* the final state served by `Predictor` (folded, confidence 0.3, 128
  detections of the top 512) through `eval/run_wider.run_wider_val`
  (batch 16, K1 on the card) and `eval/wider_eval.evaluate_wider` (IoU
  0.4) on a held-out tree of 32 images: easy AP > 0.5.

Runs under 100 steps check the plumbing, not the learning (the JAX
script's `smoke` rule). On the card unless given --device; with no card
and no --device it raises.

    python scripts/torch_train_at_scale.py [--steps 2000] [--batch 96] \\
        [--src-scale 0.6] [--keep] [--device cpu]
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

from scripts import _torch_synthetic as syn


def augment_bucket(paths):
    """The device-augment bucket that holds every source: the largest
    height and width (read from the image headers), rounded up to 32 and
    capped at 1024."""
    from PIL import Image

    mh = mw = 1
    for p in paths:
        with Image.open(p) as im:
            w, h = im.size
        mh, mw = max(mh, h), max(mw, w)
    return (min(-(-mh // 32) * 32, 1024), min(-(-mw // 32) * 32, 1024))


def train_config(args, bucket, total_epochs: int, **overrides):
    """The recipe's TrainConfig: one unfreeze phase at lr 1e-3, 32 GT
    slots, device augmentation at `bucket`."""
    from jabd_tpu_torch import configs

    base = dict(
        batch_size=args.batch,
        image_size=args.size,
        max_targets=32,
        freeze_epochs=0,  # one unfreeze phase; resume is the target
        save_period=max(total_epochs // 10, 1),
        device_augment=True,
        augment_bucket=bucket,
        lr_unfreeze=1e-3,
        total_epochs=total_epochs,
    )
    return configs.TrainConfig(**{**base, **overrides})


def epoch_losses(log_dir: str):
    """Every fit call's epoch losses, in time order (the loss_<ts> dirs)."""
    out = []
    for d in sorted(os.listdir(log_dir)):
        p = os.path.join(log_dir, d, "epoch_loss.txt")
        if os.path.isfile(p):
            with open(p) as f:
                out += [float(x) for x in f.read().split()]
    return out


def held_out_tree(root: str, val_dir: str = None, n: int = 32, src_scale: float = 1.0):
    """The held-out tree of `n` images drawn from seed 1 (under `val_dir`,
    default root/val, as event 0--Scale) and its .mat ground truth under
    root/gt. Returns (val_dir, gt_dir)."""
    val_dir = val_dir or os.path.join(root, "val")
    _, gt = syn.build_tree(val_dir, n, np.random.default_rng(1), subdir="0--Scale", src_scale=src_scale)
    return val_dir, syn.write_gt_mats(os.path.join(root, "gt"), {"0--Scale": gt})


def held_out_aps(pred, val_dir: str, gt_dir: str) -> dict:
    """Easy / medium / hard AP of a Predictor on the held-out tree: the
    batched sweep at batch 16, the evaluator at IoU 0.4."""
    from jabd_tpu_torch.eval import evaluate_wider
    from jabd_tpu_torch.eval.run_wider import run_wider_val

    return evaluate_wider(run_wider_val(pred, val_dir, batch_size=16), gt_dir, iou_thresh=0.4)


def serving_config(size: int):
    """The JAX scripts' serving config: confidence 0.3, the top 512
    candidates, 128 detections."""
    from jabd_tpu_torch import configs

    return configs.PredictConfig(
        confidence=0.3, input_shape=(size, size), max_detections=128, pre_nms_topk=512,
    )


def kernel_launches() -> dict:
    """K1 and K2 launches so far in this process (0 off the card)."""
    from jabd_tpu_torch.ops import matching_cuda, nms_cuda

    return {"k1_launches": nms_cuda.nms_keep_sorted.launches, "k2_launches": matching_cuda.match_front.launches}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--images", type=int, default=1344)
    ap.add_argument("--src-scale", type=float, default=1.0, help="shrink the synthetic source images")
    ap.add_argument("--model", default="jabd_flagship")
    ap.add_argument("--keep", action="store_true", help="keep the artifact directory")
    ap.add_argument("--root", default="", help="artifact directory (default: a new temporary one)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap


def main(argv=None) -> dict:
    from jabd_tpu_torch import configs, resolve_device, train
    from jabd_tpu_torch.data import wider as W
    from jabd_tpu_torch.predict import Predictor
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    root = args.root or tempfile.mkdtemp(prefix="scale_wider_")
    print(json.dumps({"artifact_root": root}), flush=True)
    label_txt, _ = syn.build_tree(root, args.images, rng, src_scale=args.src_scale)
    ds = W.WiderFaceDataset(label_txt, input_size=args.size)

    steps_per_epoch = max(len(ds) // args.batch, 1)
    total_epochs = max(args.steps // steps_per_epoch, 2)
    mid_epochs = total_epochs // 2
    bucket = augment_bucket(ds.imgs_path)
    print(json.dumps({"augment_bucket": bucket}), flush=True)
    mcfg = configs.get_model_config(args.model)
    ckpt_dir = os.path.join(root, "ckpt")
    log_dir = os.path.join(root, "logs")
    print(json.dumps({
        "images": len(ds), "steps_per_epoch": steps_per_epoch, "total_epochs": total_epochs,
        "interrupt_at": mid_epochs, "total_steps": steps_per_epoch * total_epochs,
    }), flush=True)

    # Phase A: to the midpoint, then stop (an interrupt at an epoch
    # boundary; the checkpoint there carries the Adam moments).
    t0 = time.time()
    train.fit(mcfg, train_config(args, bucket, mid_epochs), ds, log_dir=log_dir,
              checkpoint_manager=CheckpointManager(ckpt_dir), device=dev)
    t_a = time.time() - t0
    print(f"phase A done: {mid_epochs} epochs in {t_a:.0f}s", flush=True)

    # Phase B: a fresh fit call with the full budget must resume.
    t0 = time.time()
    state = train.fit(mcfg, train_config(args, bucket, total_epochs), ds, log_dir=log_dir,
                      checkpoint_manager=CheckpointManager(ckpt_dir), device=dev)
    t_b = time.time() - t0
    done_steps = int(state.step)
    print(f"phase B done: resumed -> epoch {total_epochs}, {t_b:.0f}s, state.step={done_steps}", flush=True)
    expect_steps = steps_per_epoch * total_epochs
    assert done_steps == expect_steps, (done_steps, expect_steps)
    # Resume discriminator: a restart from scratch would log every epoch.
    # (log_dir also holds fit's metrics.csv: only loss_<ts> dirs count.)
    phase_b_log = sorted(d for d in os.listdir(log_dir) if d.startswith("loss_"))[-1]
    with open(os.path.join(log_dir, phase_b_log, "epoch_loss.txt")) as f:
        b_epochs = len(f.read().split())
    assert b_epochs == total_epochs - mid_epochs, (
        "resume restarted from scratch?", b_epochs, total_epochs - mid_epochs,
    )
    b_steps = (total_epochs - mid_epochs) * steps_per_epoch
    print(json.dumps({
        "e2e_img_per_sec_phaseB": round(b_steps * args.batch / t_b, 1),
        "steps_per_sec_phaseB": round(b_steps / t_b, 3),
        "note": "includes the resume and the first-step overheads of phase B",
    }), flush=True)

    losses_log = epoch_losses(log_dir)
    print(f"loss curve: {losses_log[0]:.2f} -> {losses_log[-1]:.2f} ({len(losses_log)} epochs logged)",
          flush=True)
    print(json.dumps({"epoch_losses": [round(x, 4) for x in losses_log]}), flush=True)
    smoke = args.steps < 100  # tiny runs check plumbing, not learning
    assert smoke or losses_log[-1] < losses_log[0] * 0.5, "training did not learn"

    pred = Predictor(mcfg, state.model.state_dict(), serving_config(args.size), device=dev)
    aps = held_out_aps(pred, *held_out_tree(root))
    print(json.dumps({k: round(v, 4) for k, v in aps.items()}), flush=True)
    assert smoke or aps["easy"] > 0.5, f"trained model failed held-out eval: {aps}"
    print(json.dumps(kernel_launches()), flush=True)

    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    print("train_at_scale PASSED", flush=True)
    return {
        "root": root, "state_step": done_steps, "expect_steps": expect_steps, "phase_b_epochs": b_epochs,
        "total_epochs": total_epochs, "mid_epochs": mid_epochs, "losses": losses_log, "aps": aps,
    }


if __name__ == "__main__":
    main()
