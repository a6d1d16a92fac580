"""Recognition evaluation: flip-TTA embedding extraction and the 5-set
verification.

Port of the evaluation half of `jabd_tpu/recognition/train.py`
(`extract_embeddings_tta`, `extract_features_partitioned`,
`validate_5sets`, `validate_verification`). Every batch, the tail
included, is padded to `batch_size`, so a sweep runs one shape. The train
step and `fit` come with the recognition training slice; sharding a sweep
over cards (`mesh=`) with the parallelism slice.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.recognition import identification as ID
from jabd_tpu_torch.recognition import verification as V

PARALLEL = "the parallelism slice"


def extract_embeddings_tta(
    model,
    images: np.ndarray,  # [N, H, W, 3] float32 normalized
    batch_size: int = 256,
    fusion_method: str = "pre_norm_vector_add",
    use_flip_test: bool = True,
    faceness_scores: Optional[np.ndarray] = None,  # [N] detector scores
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip-TTA embeddings of `images` through the IR `model` on `device`
    (the card unless given): each batch and its copy flipped along W are
    embedded and fused by `fusion_method`
    (`identification.fuse_features_with_norm`). Returns ([N, 512]
    embeddings, [N, 1] norms)."""
    if mesh is not None:
        raise NotImplementedError(f"the PyTorch port does not have yet: mesh= extraction: {PARALLEL}")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    embs, norms = [], []
    for lo in range(0, len(images), batch_size):
        xs = np.asarray(images[lo : lo + batch_size], np.float32)
        nb = len(xs)
        if nb < batch_size:  # pad the tail: one shape for the whole sweep
            xs = np.concatenate([xs, np.zeros((batch_size - nb, *xs.shape[1:]), xs.dtype)])
        x = torch.from_numpy(xs).to(dev).permute(0, 3, 1, 2)
        with torch.inference_mode():
            e1, n1 = (t[:nb].cpu().numpy() for t in model(x))
            if not use_flip_test:
                embs.append(e1)
                norms.append(n1)
                continue
            e2, n2 = (t[:nb].cpu().numpy() for t in model(torch.flip(x, dims=(3,))))
        fs = faceness_scores[lo : lo + batch_size] if faceness_scores is not None else None
        fused, fused_norm = ID.fuse_features_with_norm(
            np.stack([e1, e2]), np.stack([n1, n2]), fusion_method=fusion_method, faceness_scores=fs
        )
        embs.append(fused)
        norms.append(fused_norm)
    return np.concatenate(embs), np.concatenate(norms)


def extract_features_partitioned(
    model,
    image_loader,  # callable(index) -> [H, W, 3] float32 normalized image
    num_images: int,
    num_partitions: int = 100,
    batch_size: int = 256,
    save_dir: Optional[str] = None,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extraction in bounded-memory partitions, each saved to
    `<save_dir>/features_part<p>.npz` and read back instead of recomputed
    when that file exists (resume). Returns ([N, 512] embeddings, [N, 1]
    norms)."""
    part_size = math.ceil(num_images / num_partitions)
    all_emb, all_norm = [], []
    for p in range(num_partitions):
        lo = p * part_size
        hi = min(lo + part_size, num_images)
        if lo >= hi:
            break
        part_file = os.path.join(save_dir, f"features_part{p}.npz") if save_dir else None
        if part_file and os.path.exists(part_file):
            z = np.load(part_file)
            all_emb.append(z["emb"])
            all_norm.append(z["norm"])
            continue
        images = np.stack([image_loader(i) for i in range(lo, hi)])
        emb, norm = extract_embeddings_tta(model, images, batch_size, mesh=mesh, device=device)
        if part_file:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(part_file, emb=emb, norm=norm)
        all_emb.append(emb)
        all_norm.append(norm)
    return np.concatenate(all_emb), np.concatenate(all_norm)


def validate_5sets(model, data_dir: str, batch_size: int = 256, device=None) -> Dict[str, Dict[str, float]]:
    """Flip-TTA 10-fold accuracy on each of the five validation sets found
    under `data_dir`, and their mean (`val_acc`). Raises FileNotFoundError
    when none is there."""
    from jabd_tpu_torch.recognition.data import load_five_validation_sets

    out: Dict[str, Dict[str, float]] = {}
    accs = []
    for name, (data, issame) in load_five_validation_sets(data_dir).items():
        res = validate_verification(model, np.asarray(data), np.asarray(issame), batch_size, device=device)
        out[name] = res
        accs.append(res["val_acc"])
    if not accs:
        raise FileNotFoundError(
            f"no validation sets found under {data_dir!r} "
            "(expected agedb_30/cfp_fp/lfw/cplfw/calfw memfiles or bins)"
        )
    out["mean"] = {"val_acc": float(np.mean(accs))}
    return out


def validate_verification(
    model,
    data: np.ndarray,  # [N, H, W, 3] uint8 or normalized float
    issame: np.ndarray,
    batch_size: int = 256,
    device=None,
) -> Dict[str, float]:
    """10-fold verification accuracy on one set (even rows against odd
    rows)."""
    if data.dtype == np.uint8:
        data = (data.astype(np.float32) / 255.0 - 0.5) / 0.5
    emb, _ = extract_embeddings_tta(model, data, batch_size, device=device)
    _, _, accuracy, best_thresholds = V.evaluate(emb, issame)
    return {
        "val_acc": float(accuracy.mean()),
        "val_acc_std": float(accuracy.std()),
        "best_threshold": float(best_thresholds.mean()),
    }
