"""Overfit synthetic identities with the PyTorch port's recognition step.

The twin of scripts/overfit_recognition.py on `jabd_tpu_torch`: ir_18
(train-mode BatchNorm, PReLU, dropout) under bf16 autocast, the AdaFace
head over 16 identities (norm EMA, float32), SGD lr 0.05 with the
BatchNorm / no-decay split and milestones at 2/3 and 9/10 of the steps,
batches of 64 renders of random identities (brightness, contrast,
translation, noise, flip). Then fresh renders (unseen jitter draws) of
each identity are embedded and must separate. Passes, as the JAX script
does, when the loss falls below 0.2 x the first, train accuracy exceeds
0.95, 1-NN identification of the fresh renders reaches 0.95 and the
genuine cosine mean exceeds the impostor one by more than 0.3. Neither
CUDA kernel lies on this path.

    python scripts/torch_overfit_recognition.py [steps] [--device cpu]

Runs on the card unless given --device; with no card and no --device it
raises. Below 10 steps the default milestones collide (a ValueError):
pass `milestones` to `main` there.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from scripts import _torch_synthetic as syn

IDS, BS = 16, 64
ARCH = "ir_18"


def separation(emb: np.ndarray, labels: np.ndarray) -> dict:
    """Genuine (same identity, off the diagonal) and impostor cosines of
    unit embeddings, and 1-NN identification accuracy with the diagonal
    masked: the JAX script's formulas."""
    sims = emb @ emb.T
    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(emb), dtype=bool)
    genuine = sims[same & off]
    impostor = sims[~same]
    nn_idx = np.argmax(np.where(off, sims, -2.0), axis=1)
    return {
        "genuine_mean": float(genuine.mean()),
        "genuine_min": float(genuine.min()),
        "impostor_mean": float(impostor.mean()),
        "impostor_max": float(impostor.max()),
        "nn_acc": float(np.mean(labels[nn_idx] == labels)),
    }


def passed(first_loss: float, final_loss: float, final_acc: float, sep: dict) -> bool:
    """The JAX script's four criteria."""
    return (
        final_loss < first_loss * 0.2
        and final_acc > 0.95
        and sep["nn_acc"] >= 0.95
        and sep["genuine_mean"] > sep["impostor_mean"] + 0.3
    )


def main(steps: int = 300, seed: int = 0, device=None, milestones=None) -> bool:
    """Train `steps` steps, then return whether all four criteria hold."""
    from jabd_tpu_torch import resolve_device
    from jabd_tpu_torch.recognition import build_head, build_model
    from jabd_tpu_torch.recognition import train as RT

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bases = [syn.identity_base(i) for i in range(IDS)]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(ARCH, device="cpu")
    model = model.to(dev)
    head = build_head("adaface", class_num=IDS, seed=seed, device=dev)
    state = RT.create_state(
        model, head, num_train_steps_hint=steps, lr=0.05,
        milestones=milestones or (steps * 2 // 3, steps * 9 // 10),
    )
    step = RT.make_train_step(compute_dtype="bfloat16", seed=seed + 1)

    first_loss = None
    for it in range(steps):
        imgs, labels = syn.make_identity_batch(rng, bases, BS)
        state, m = step(
            state,
            torch.from_numpy(np.asarray(imgs, np.float32)).to(dev),
            torch.from_numpy(labels).to(dev),
        )
        if it % 50 == 0 or it == steps - 1:
            loss, acc = float(m["loss"]), float(m["acc"])
            if first_loss is None:
                first_loss = loss
            print(f"step {it}: loss={loss:.3f} acc={acc:.3f}", flush=True)

    # Embedding separation on fresh renders (unseen jitter draws).
    eval_rng = np.random.default_rng(seed + 777)
    per_id = 8
    imgs = np.stack([syn.render_float(bases[i], eval_rng) for i in range(IDS) for _ in range(per_id)])
    labels = np.repeat(np.arange(IDS), per_id)
    x = torch.from_numpy(((imgs / 255.0 - 0.5) / 0.5).astype(np.float32)).to(dev).permute(0, 3, 1, 2)
    state.model.eval()
    with torch.inference_mode(), torch.autocast(dev.type, dtype=torch.bfloat16):
        emb, _ = state.model(x)
    sep = separation(emb.float().cpu().numpy(), labels)
    print(
        f"fresh-render separation: genuine cos {sep['genuine_mean']:.3f} "
        f"(min {sep['genuine_min']:.3f}), impostor cos {sep['impostor_mean']:.3f} "
        f"(max {sep['impostor_max']:.3f}); 1-NN id acc {sep['nn_acc']:.3f}",
        flush=True,
    )
    final_loss, final_acc = float(m["loss"]), float(m["acc"])
    ok = passed(first_loss, final_loss, final_acc, sep)
    print(f"{'PASSED' if ok else 'FAILED'}: loss {first_loss:.2f} -> {final_loss:.3f}, "
          f"train acc {final_acc:.3f}", flush=True)
    return ok


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return 0 if main(args.steps, args.seed, args.device) else 1


if __name__ == "__main__":
    sys.exit(cli())
