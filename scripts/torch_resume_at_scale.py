"""Continue a `torch_train_at_scale.py --keep` run from a fresh process
(crash recovery through the same auto-resume path), with the PyTorch port.

The twin of scripts/resume_at_scale.py: `train.fit` resumes from the
directory's newest checkpoint (its Adam moments included) and runs to the
budget of --steps (a larger --steps than the kept run's continues it;
the same one restores and stops). `state.step` must be exact, the loss
curve over every fit call must halve, and the final state must score easy
AP > 0.5 on the held-out tree (built again from seed 1, in val2/ when
val/ exists). As in torch_train_at_scale.py, runs under 100 steps check
the plumbing, not the learning (the JAX resume script has no such rule:
it is the one that lets a tiny CPU run through).

    python scripts/torch_resume_at_scale.py <root> [--steps 2000] \\
        [--batch 96] [--size 640] [--model jabd_flagship] [--device cpu]

On the card unless given --device; with no card and no --device it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import torch_train_at_scale as at_scale


def main(argv=None) -> dict:
    from jabd_tpu_torch import configs, resolve_device, train
    from jabd_tpu_torch.data import wider as W
    from jabd_tpu_torch.predict import Predictor
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--model", default="jabd_flagship")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    root = args.root

    ds = W.WiderFaceDataset(os.path.join(root, "label.txt"), input_size=args.size)
    steps_per_epoch = max(len(ds) // args.batch, 1)
    total_epochs = max(args.steps // steps_per_epoch, 2)
    bucket = at_scale.augment_bucket(ds.imgs_path)
    mcfg = configs.get_model_config(args.model)
    log_dir = os.path.join(root, "logs")
    cm = CheckpointManager(os.path.join(root, "ckpt"))
    resumed_from = cm.latest_step()
    print(json.dumps({"resume_from_epoch": resumed_from, "total_epochs": total_epochs}), flush=True)

    t0 = time.time()
    state = train.fit(mcfg, at_scale.train_config(args, bucket, total_epochs), ds, log_dir=log_dir,
                      checkpoint_manager=cm, device=dev)
    t_c = time.time() - t0
    done_steps = int(state.step)
    expect = steps_per_epoch * total_epochs
    assert done_steps == expect, (done_steps, expect)
    print(f"continuation done: epochs {resumed_from}->{total_epochs} in {t_c:.0f}s, state.step={done_steps}",
          flush=True)

    losses_log = at_scale.epoch_losses(log_dir)
    print(f"loss curve: {losses_log[0]:.2f} -> {losses_log[-1]:.2f} ({len(losses_log)} epoch records)",
          flush=True)
    smoke = args.steps < 100  # tiny runs check plumbing, not learning
    assert smoke or losses_log[-1] < losses_log[0] * 0.5, "did not learn"

    val_dir = os.path.join(root, "val2" if os.path.isdir(os.path.join(root, "val")) else "val")
    pred = Predictor(mcfg, state.model.state_dict(), at_scale.serving_config(args.size), device=dev)
    aps = at_scale.held_out_aps(pred, *at_scale.held_out_tree(root, val_dir))
    print(json.dumps({k: round(v, 4) for k, v in aps.items()}), flush=True)
    assert smoke or aps["easy"] > 0.5, f"trained model failed held-out eval: {aps}"
    print(json.dumps(at_scale.kernel_launches()), flush=True)
    print("resume_at_scale PASSED", flush=True)
    return {"resumed_from": resumed_from, "state_step": done_steps, "expect_steps": expect,
            "losses": losses_log, "aps": aps}


if __name__ == "__main__":
    main()
