"""WIDER FACE training batches: label parsing, padded targets, the
shuffled epoch skeleton and `train_loader`.

Port of the numpy parts of `jabd_tpu/data/wider.py` (`parse_wider_labels`,
`batch_targets`, `sample_rng`, `epoch_batches`, `backfill_batch`,
`train_loader`). Targets are padded to a static [B, G, 15] layout with a
validity mask instead of the reference's ragged list, and a sample that
loses every box to augmentation is re-drawn, then replaced by a survivor,
so that every batch is full (the reference's detection_collate drops
it). The dataset is any object with `__len__` and `get(idx, rng)`
returning (float32 HWC image, [N, 15] target); the WIDER image dataset
with the PIL/cv2 augmentation comes in a later slice.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def parse_wider_labels(txt_path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Parse the retinaface-style label.txt: lines `# <relpath>`, then
    per face `x y w h lx0 ly0 v0 ... lx4 ly4 v4 [conf]`. Returns (image
    paths, [N, 15] float32 arrays: x1 y1 x2 y2, 5 x (lx, ly), flag 1 with
    landmarks / -1 without), as utils/dataloader.py:21-66,151-175."""
    imgs_path: List[str] = []
    raw: List[List[List[float]]] = []
    labels: List[List[float]] = []
    first = True
    img_dir = txt_path.replace("label.txt", "images/")
    with open(txt_path, "r") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith("#"):
                if first:
                    first = False
                else:
                    raw.append(labels.copy())
                    labels.clear()
                imgs_path.append(img_dir + line[2:])
            elif line:
                labels.append([float(x) for x in line.split(" ")])
    raw.append(labels)

    annos: List[np.ndarray] = []
    for faces in raw:
        a = np.zeros((len(faces), 15), np.float32)
        for i, lb in enumerate(faces):
            a[i, 0] = lb[0]
            a[i, 1] = lb[1]
            a[i, 2] = lb[0] + lb[2]
            a[i, 3] = lb[1] + lb[3]
            for p in range(5):  # landmark columns skip the visibility flags
                a[i, 4 + 2 * p] = lb[4 + 3 * p]
                a[i, 5 + 2 * p] = lb[5 + 3 * p]
            a[i, 14] = -1.0 if a[i, 4] < 0 else 1.0
        annos.append(a)
    return imgs_path, annos


def batch_targets(
    targets: Sequence[np.ndarray], max_targets: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Ragged [N_i, 15] targets -> (boxes [B, G, 4], labels [B, G],
    landms [B, G, 10], valid [B, G]); GTs beyond max_targets are dropped."""
    b = len(targets)
    boxes = np.zeros((b, max_targets, 4), np.float32)
    labels = np.zeros((b, max_targets), np.float32)
    landms = np.zeros((b, max_targets, 10), np.float32)
    valid = np.zeros((b, max_targets), bool)
    for i, t in enumerate(targets):
        n = min(len(t), max_targets)
        if n:
            boxes[i, :n] = t[:n, :4]
            landms[i, :n] = t[:n, 4:14]
            labels[i, :n] = t[:n, 14]
            valid[i, :n] = True
    return boxes, labels, landms, valid


def sample_rng(seed: int, idx: int, attempt: int = 0) -> np.random.Generator:
    """The augmentation RNG stream of one (sample, attempt)."""
    return np.random.default_rng(
        (seed * 1_000_003 + int(idx) * 7919 + attempt) & 0x7FFFFFFF
    )


def epoch_batches(
    n: int, batch_size: int, seed: int, drop_last: bool = True
) -> Iterator[np.ndarray]:
    """Shuffled index batches of one epoch (DataLoader shuffle +
    drop_last, train_mobilenetV3_ecagai.py:568-569)."""
    order = np.random.default_rng(seed).permutation(n)
    cursor = 0
    while cursor + batch_size <= n or (not drop_last and cursor < n):
        yield order[cursor : cursor + batch_size]
        cursor += batch_size


def backfill_batch(idxs, results, refetch, is_empty, batch_size: int):
    """Re-draw samples that lost every box (refetch(idx, attempt), up to
    8 draws), drop the still-empty, and fill the batch round-robin with
    the survivors. Returns [] when nothing survived."""
    out = []
    for idx, res in zip(idxs, results):
        attempt = 1
        while is_empty(res) and attempt < 8:
            res = refetch(idx, attempt)
            attempt += 1
        if not is_empty(res):
            out.append(res)
    if not out:
        return []
    n_live = len(out)
    while len(out) < batch_size:
        out.append(out[(len(out) - n_live) % n_live])
    return out


def train_loader(
    dataset,
    batch_size: int,
    max_targets: int = 128,
    seed: int = 0,
    num_workers: int = 8,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, Tuple[np.ndarray, ...]]]:
    """One epoch of shuffled, padded batches: (images [B, H, W, 3],
    (boxes, labels, landms, valid)). Samples are fetched in a thread
    pool, each with its own `sample_rng` stream."""
    pool = cf.ThreadPoolExecutor(max_workers=num_workers)
    try:

        def fetch(idx, attempt=0):
            return dataset.get(int(idx), sample_rng(seed, idx, attempt))

        for idxs in epoch_batches(len(dataset), batch_size, seed, drop_last):
            results = backfill_batch(
                idxs,
                list(pool.map(fetch, idxs)),
                fetch,
                lambda r: len(r[1]) == 0,
                batch_size,
            )
            if not results:
                continue
            images = np.stack([im for im, _ in results])
            tgts = batch_targets([t for _, t in results], max_targets)
            yield images, tgts
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
