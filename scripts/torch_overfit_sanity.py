"""Overfit on synthetic detection data with the PyTorch port: the detector
step LEARNS, and detection after training finds what it learned.

The twin of scripts/overfit_sanity.py on `jabd_tpu_torch`: mnet_v3_plain
at 128x128, batch 16, 1-2 bright squares per grey canvas, 400 steps of
`train.make_train_step` (dense matching through the CUDA kernel K2 on the
card, MultiBox loss, hard-negative mining, Adam at a constant 1e-3 under
bf16 autocast), then `predict.detect_batch` on 16 fresh canvases (greedy
NMS through the CUDA kernel K1 on the card). Passes with recall@0.5 >=
0.9, the JAX script's criterion.

    python scripts/torch_overfit_sanity.py [--steps 400] [--device cpu]

Runs on the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from scripts import _torch_synthetic as syn

SIZE, BS, G = 128, 16, 4
PRESET = "mnet_v3_plain"


def recall_counts(dets: np.ndarray, dvalid: np.ndarray, gt_boxes, size: int):
    """The JAX scripts' recall@0.5 counting: a ground-truth box (pixel
    corners) is found when some valid detection (normalized corners) of
    its image overlaps it with IoU > 0.5. Returns (found, ground-truth
    boxes, valid detections)."""
    tp, total_gt, total_det = 0, 0, 0
    for i, gt in enumerate(gt_boxes):
        d = dets[i][dvalid[i]]
        total_gt += len(gt)
        total_det += len(d)
        for g in gt:
            if len(d):
                xx1 = np.maximum(d[:, 0] * size, g[0])
                yy1 = np.maximum(d[:, 1] * size, g[1])
                xx2 = np.minimum(d[:, 2] * size, g[2])
                yy2 = np.minimum(d[:, 3] * size, g[3])
                inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
                union = (
                    (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1]) * size * size
                    + (g[2] - g[0]) * (g[3] - g[1])
                    - inter
                )
                if (inter / np.maximum(union, 1e-9)).max() > 0.5:
                    tp += 1
    return tp, total_gt, total_det


def detect(model, mcfg, imgs: np.ndarray, anchors: torch.Tensor, size: int):
    """`predict.detect_batch` of mean-subtracted NHWC canvases on the
    model's device, at the JAX scripts' PredictConfig, in the preset's
    compute dtype. Returns (dets, valid) as numpy."""
    from jabd_tpu_torch import configs
    from jabd_tpu_torch.predict import detect_batch

    pcfg = configs.PredictConfig(
        confidence=0.5, input_shape=(size, size), max_detections=32, pre_nms_topk=64,
    )
    x = torch.from_numpy(imgs).to(anchors.device).permute(0, 3, 1, 2)
    model.eval()
    with torch.inference_mode(), torch.autocast(
        x.device.type, dtype=torch.bfloat16, enabled=mcfg.compute_dtype == "bfloat16"
    ):
        dets, dvalid = detect_batch(model, x, anchors, pcfg, variances=mcfg.anchors.variance)
    return dets.float().cpu().numpy(), dvalid.cpu().numpy()


def report_recall(dets, dvalid, gt_boxes, size: int) -> float:
    tp, total_gt, total_det = recall_counts(dets, dvalid, gt_boxes, size)
    recall = tp / max(total_gt, 1)
    print(f"recall@0.5: {tp}/{total_gt} = {recall:.2f}; detections: {total_det}", flush=True)
    return recall


def train_steps(state, step, anchors: torch.Tensor, rng, steps: int, size=None, bs=None, g=None):
    """`steps` steps on fresh `make_batch` canvases drawn from `rng`, on
    the anchors' device (size, batch and GT slots default to the module's
    SIZE, BS and G). Returns (state, each step's loss as a 0-d tensor)."""
    from jabd_tpu_torch import losses

    size, bs, g = size or SIZE, bs or BS, g or G
    dev = anchors.device
    out = []
    for it in range(steps):
        imgs, boxes, valid = syn.make_batch(rng, bs, size, g)
        targets = losses.Targets(
            torch.from_numpy(boxes).to(dev),
            torch.ones((bs, g), device=dev),
            torch.zeros((bs, g, 10), device=dev),
            torch.from_numpy(valid).to(dev),
        )
        state, m = step(state, torch.from_numpy(imgs).to(dev), targets, anchors)
        out.append(m["loss"])
        if it % 100 == 0:
            print(f"step {it}: loss={float(m['loss']):.3f}", flush=True)
    return state, out


def main(steps: int = 400, seed: int = 0, device=None) -> float:
    """Train `steps` steps from the seeded init, then return recall@0.5 on
    16 fresh canvases."""
    from jabd_tpu_torch import configs, resolve_device, train
    from jabd_tpu_torch.ops import anchors as A

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mcfg = configs.get_model_config(PRESET)
    tcfg = configs.TrainConfig(batch_size=BS, image_size=SIZE, max_targets=G, lr_freeze=1e-3, seed=seed)
    # 10,000 steps an epoch: StepLR never decays within the run.
    state = train.create_train_state(mcfg, tcfg, steps_per_epoch=10_000, device=dev)
    anchors = torch.from_numpy(A.generate_anchors(mcfg.anchors, (SIZE, SIZE)).copy()).to(dev)
    state, _ = train_steps(state, train.make_train_step(mcfg, tcfg), anchors, rng, steps)

    imgs, boxes, valid = syn.make_batch(rng, 16, SIZE, G)
    dets, dvalid = detect(state.model, mcfg, imgs, anchors, SIZE)
    gt = [boxes[i][valid[i]] * SIZE for i in range(16)]
    return report_recall(dets, dvalid, gt, SIZE)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    assert main(args.steps, args.seed, args.device) >= 0.9, "training sanity failed: recall < 0.9"
    print("overfit sanity PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
