"""Int8 serving accuracy at the AP level on trained weights, with the
PyTorch port.

The twin of scripts/int8_ap_delta.py on `jabd_tpu_torch`: `train.fit` in
one phase with torch_train_at_scale.py's recipe (loaded by file path) on a
synthetic WIDER tree, then Easy / Medium / Hard AP on a held-out tree
(the sweep at batch 16, K1 on the card, the evaluator at IoU 0.4) for
each serving mode of the trained weights:

  bf16             - the folded serving default (`Predictor`),
  int8 absmax      - `Predictor.quantize_int8`, absmax calibration
                     (`models/quantize.py::calibrate`),
  int8 err search  - the clip ratio scored by end-to-end output error,
  int8 AP search   - the clip ratio scored by mean WIDER AP, through the
                     wiring of `cli map-txt --quantize int8
                     --quantize-search --gt-dir` (`cli.
                     _quantize_for_map_txt`; it scores at the evaluator's
                     default IoU, 0.5, as the command does).

Every mode calibrates on the held-out tree's first 8 images, decoded as
serving decodes them. A report: no pass criterion.

    python scripts/torch_int8_ap_delta.py [--model jabd_flagship] \\
        [--steps 800] [--batch 48] [--size 640] [--device cpu]

On the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _load_at_scale():
    spec = importlib.util.spec_from_file_location(
        "torch_train_at_scale",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_train_at_scale.py"),
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def main(argv=None) -> dict:
    from jabd_tpu_torch import cli, configs, resolve_device, train
    from jabd_tpu_torch.data import wider as W
    from jabd_tpu_torch.predict import Predictor

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="jabd_flagship")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--images", type=int, default=672)
    ap.add_argument("--val-images", type=int, default=32)
    ap.add_argument("--src-scale", type=float, default=1.0)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    at_scale = _load_at_scale()
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="int8_ap_")

    # Train: one production fit call, device augmentation, no checkpoints.
    label_txt, _ = at_scale.syn.build_tree(root, args.images, rng, src_scale=args.src_scale)
    ds = W.WiderFaceDataset(label_txt, input_size=args.size)
    steps_per_epoch = max(len(ds) // args.batch, 1)
    total_epochs = max(args.steps // steps_per_epoch, 2)
    bucket = at_scale.augment_bucket(ds.imgs_path)
    mcfg = configs.get_model_config(args.model)
    tcfg = at_scale.train_config(args, bucket, total_epochs, save_period=10**9)
    print(json.dumps({"model": args.model, "train_steps": steps_per_epoch * total_epochs,
                      "epochs": total_epochs}), flush=True)
    state = train.fit(mcfg, tcfg, ds, log_dir=os.path.join(root, "logs"), device=dev)
    weights = state.model.state_dict()

    val_dir, gt_dir = at_scale.held_out_tree(root, n=args.val_images, src_scale=args.src_scale)
    pcfg = at_scale.serving_config(args.size)
    sample = cli._val_samples(val_dir)

    def predictor():
        return Predictor(mcfg, weights, pcfg, device=dev)

    results = {}

    def report(tag, pred, extra=None):
        aps = at_scale.held_out_aps(pred, val_dir, gt_dir)
        rec = {k: round(v, 4) for k, v in aps.items()}
        if "bf16" in results:
            rec["delta_vs_bf16"] = {k: round(aps[k] - results["bf16"][k], 4) for k in aps}
        rec.update(extra or {})
        results[tag] = dict(aps)
        print(json.dumps({tag: rec}), flush=True)

    report("bf16", predictor())

    p_abs = predictor()
    n = p_abs.quantize_int8(sample, search_clip=False)
    report("int8_absmax", p_abs, {"quantized_sites": n})

    p_err = predictor()
    p_err.quantize_int8(sample, search_clip=True)
    report("int8_err_search", p_err)

    p_ap = predictor()
    cli._quantize_for_map_txt(
        argparse.Namespace(val_dir=val_dir, quantize_search=True, gt_dir=gt_dir, batch_size=16), p_ap,
    )
    report("int8_ap_search", p_ap)
    print(json.dumps(at_scale.kernel_launches()), flush=True)

    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    print("int8_ap_delta DONE", flush=True)
    return results


if __name__ == "__main__":
    main()
