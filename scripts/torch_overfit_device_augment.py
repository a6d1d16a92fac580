"""Overfit through the device-augmentation path with the PyTorch port.

The twin of scripts/overfit_device_augment.py on `jabd_tpu_torch`: a mini
WIDER tree of 64 JPEGs (bright squares as faces), then the production
device-augment pipeline, epoch after epoch re-seeded seed + epoch: JPEG
decode and plan building on the host (`data/device_augment.
device_train_loader`, bucket 256x256), the uint8 bucket and the plan
copied to the device, and the train step with `device_augment` (resample
and HSV on the device, forward, matching through K2 on the card, MultiBox,
Adam). Then `predict.detect_batch` (K1 on the card) on 16 clean canvases.
Passes with recall@0.5 >= 0.9, the JAX script's criterion.

    python scripts/torch_overfit_device_augment.py [--steps 400] [--device cpu]

Runs on the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from scripts import _torch_synthetic as syn
from scripts.torch_overfit_sanity import PRESET, detect, report_recall

SIZE, BS, G = 128, 16, 8
BUCKET = (256, 256)
IMAGES = 64


def main(steps: int = 400, seed: int = 0, device=None) -> float:
    """Train `steps` device-augmented steps over the mini tree, then
    return recall@0.5 on 16 clean canvases."""
    from jabd_tpu_torch import configs, losses, resolve_device, train
    from jabd_tpu_torch.data import device_augment as DA
    from jabd_tpu_torch.data import wider as W
    from jabd_tpu_torch.ops import anchors as A

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    root = tempfile.mkdtemp(prefix="mini_wider_")
    try:
        ds = W.WiderFaceDataset(syn.build_dataset(root, IMAGES, rng), input_size=SIZE)
        mcfg = configs.get_model_config(PRESET)
        tcfg = configs.TrainConfig(
            batch_size=BS, image_size=SIZE, max_targets=G, lr_freeze=1e-3,
            device_augment=True, augment_bucket=BUCKET, seed=seed,
        )
        state = train.create_train_state(mcfg, tcfg, steps_per_epoch=10_000, device=dev)
        step = train.make_train_step(mcfg, tcfg)
        anchors = torch.from_numpy(A.generate_anchors(mcfg.anchors, (SIZE, SIZE)).copy()).to(dev)

        it = 0
        epoch = 0
        while it < steps:
            for images_u8, plan, tgt in DA.device_train_loader(
                ds, BS, bucket_hw=BUCKET, max_targets=G, seed=seed + epoch,
            ):
                targets = losses.Targets(*(torch.from_numpy(t).to(dev) for t in tgt))
                plan_d = type(plan)(*(t.to(dev) for t in plan))
                state, m = step(state, torch.from_numpy(images_u8).to(dev), plan_d, targets, anchors)
                if it % 100 == 0:
                    print(f"step {it}: loss={float(m['loss']):.3f}", flush=True)
                it += 1
                if it >= steps:
                    break
            epoch += 1
    finally:
        shutil.rmtree(root, ignore_errors=True)

    imgs, gt_boxes = syn.clean_canvases(rng, 16, SIZE)
    dets, dvalid = detect(state.model, mcfg, imgs, anchors, SIZE)
    return report_recall(dets, dvalid, gt_boxes, SIZE)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    assert main(args.steps, args.seed, args.device) >= 0.9, "device-augment training sanity failed"
    print("device-augment overfit sanity PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
