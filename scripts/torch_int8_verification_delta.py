"""Int8 serving accuracy at the verification level on a trained embedder,
with the PyTorch port.

The twin of scripts/int8_verification_delta.py on `jabd_tpu_torch`:
`recognition.train.fit` with torch_train_recognition_at_scale.py's recipe
(loaded by file path; the device-augmented step, bf16 autocast), then
held-out 10-fold verification accuracy (`validate_5sets`, flip TTA) for
each serving mode of the trained backbone:

  bf16           - the trained weights in bfloat16,
  bf16 + fold    - BatchNorms folded (in float32), then bfloat16,
  int8 absmax    - the folded bf16 model with int8 sites calibrated on 16
                   held-out faces (`models/quantize.py`),
  int8 + search  - the clip ratio scored by end-to-end output error.

A report: no pass criterion. Neither CUDA kernel lies on this path.

    python scripts/torch_int8_verification_delta.py [--arch ir_18] \\
        [--epochs 30] [--batch 64] [--device cpu]

On the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def _load_at_scale():
    spec = importlib.util.spec_from_file_location(
        "torch_train_recognition_at_scale",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_train_recognition_at_scale.py"),
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def main(argv=None) -> dict:
    from jabd_tpu_torch import resolve_device
    from jabd_tpu_torch.models import quantize as Q
    from jabd_tpu_torch.recognition import train as RT
    from jabd_tpu_torch.recognition.data import ImageFolderDataset, load_five_validation_sets
    from jabd_tpu_torch.recognition.fold import fold_ir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="ir_18")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ids", type=int, default=32)
    ap.add_argument("--per-id", type=int, default=24)
    ap.add_argument("--val-pairs", type=int, default=120)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    at_scale = _load_at_scale()
    root = tempfile.mkdtemp(prefix="int8_ver_")
    at_scale.build_data(root, args.ids, args.per_id, args.val_pairs)
    val_dir = os.path.join(root, "val")
    ds = ImageFolderDataset(os.path.join(root, "train"))
    steps_per_epoch = len(ds) // args.batch
    state = at_scale.new_state(args.arch, ds.num_classes, steps_per_epoch, args.epochs, dev)
    step = RT.make_train_step_aug(compute_dtype="bfloat16", seed=0)
    print(json.dumps({"arch": args.arch, "images": len(ds), "classes": ds.num_classes,
                      "epochs": args.epochs}), flush=True)
    state = RT.fit(state, step, ds, args.batch, args.epochs, device_augment=True, seed=0, val_dir=val_dir,
                   checkpoint_dir=os.path.join(root, "ck"), device=dev)
    trained = state.model.eval()

    # Calibration sample: held-out faces through serving normalization.
    data0 = np.asarray(next(iter(load_five_validation_sets(val_dir).values()))[0])
    if data0.dtype == np.uint8:
        data0 = (data0.astype(np.float32) / 255.0 - 0.5) / 0.5
    sample = torch.from_numpy(np.ascontiguousarray(data0[:16])).to(dev).permute(0, 3, 1, 2)

    results = {}

    def report(tag, model, extra=None):
        acc = RT.validate_5sets(model, val_dir, device=dev)["mean"]["val_acc"]
        rec = {"val_acc": round(acc, 4)}
        if "bf16_fold" in results:
            rec["delta_vs_fold"] = round(acc - results["bf16_fold"], 4)
        rec.update(extra or {})
        results[tag] = acc
        print(json.dumps({tag: rec}), flush=True)

    report("bf16", copy.deepcopy(trained).to(torch.bfloat16))
    folded = fold_ir(copy.deepcopy(trained)).to(torch.bfloat16)
    report("bf16_fold", folded)

    calib = Q.calibrate(folded, [sample])
    q_abs = copy.deepcopy(folded)
    n = Q.quantize_model(q_abs, calib)
    report("int8_absmax", q_abs, {"quantized_sites": n})

    ratio, _ = Q.search_clip_ratio(folded, calib, [sample])
    q_s = copy.deepcopy(folded)
    Q.quantize_model(q_s, calib, clip_ratio=ratio)
    report("int8_err_search", q_s, {"clip_ratio": ratio})

    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    print("int8_verification_delta DONE", flush=True)
    return results


if __name__ == "__main__":
    main()
