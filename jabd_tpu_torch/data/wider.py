"""WIDER FACE training data: label parsing, the reference's augmentation,
the dataset, padded targets, the shuffled epoch skeleton and
`train_loader`.

Port of `jabd_tpu/data/wider.py`. Targets are padded to a static
[B, G, 15] layout with a validity mask instead of the reference's ragged
list, and a sample that loses every box to augmentation is re-drawn, then
replaced by a survivor, so that every batch is full (the reference's
detection_collate drops it). `train_loader` takes any dataset with
`__len__` and `get(idx, rng)` returning (float32 HWC image, [N, 15]
target); `WiderFaceDataset` is the one over a label.txt.

`augment_sample` takes a decoded uint8 RGB array: its resize is
`ops/image.pil_bicubic_resize` (PIL's bicubic, byte for byte, in numpy)
and its HSV jitter is `ops/image.hsv_jitter` on a CPU tensor, the function
the device augmentation runs too. Only `WiderFaceDataset.load_image` needs
PIL, to decode a file.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from jabd_tpu_torch.ops.image import hsv_jitter, pil_bicubic_resize, preprocess_input_np


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


@dataclasses.dataclass(frozen=True)
class AugmentDraw:
    """The random decisions of one `get_random_data` call
    (utils/dataloader.py:71-113), apart from the pixel work, so that the
    host and the device pipelines share one RNG consumption order and one
    box geometry."""

    nw: int  # resized width before paste
    nh: int  # resized height
    dx: int  # paste offset x (can be negative)
    dy: int  # paste offset y
    flip: bool
    dh: float  # hue shift (fraction; applied as dh*360 in cv2 H degrees)
    ds: float  # saturation scale
    dv: float  # value scale


def draw_augment_params(
    rng: np.random.Generator,
    input_size: int,
    jitter: float = 0.3,
    hue: float = 0.1,
    sat: float = 1.5,
    val: float = 1.5,
) -> AugmentDraw:
    """Consume RNG draws in exactly the reference's order
    (utils/dataloader.py:78-113): aspect (2 draws), scale, dx, dy, flip,
    hue, sat (cond+value), val (cond+value)."""

    def rand(a=0.0, b=1.0):
        return rng.random() * (b - a) + a

    h = w = input_size
    new_ar = (w / h) * rand(1 - jitter, 1 + jitter) / rand(1 - jitter, 1 + jitter)
    scale = rand(0.25, 3.25)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    # nw/nh stay raw (box math uses them); resize callers clamp to >= 1.
    # rand(0, w-nw) also when w-nw is negative (u*(w-nw), u~U[0,1)): the
    # paste offset depends on this form (utils/dataloader.py:92-93).
    dx = int(rand(0, w - nw))
    dy = int(rand(0, h - nh))
    flip = rand() < 0.5
    dh = rand(-hue, hue)
    ds = rand(1, sat) if rand() < 0.5 else 1 / rand(1, sat)
    dv = rand(1, val) if rand() < 0.5 else 1 / rand(1, val)
    return AugmentDraw(nw, nh, dx, dy, flip, dh, ds, dv)


def transform_boxes(
    box: np.ndarray,
    draw: AugmentDraw,
    image_wh: Tuple[int, int],
    input_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Apply the draw's geometry to [N, 15] annotations: shuffle, map to
    canvas coords, flip remap, center filter, clip, >1px filter, zero
    flagged landmarks, normalize (utils/dataloader.py:115-147).

    The one draw here (`rng.shuffle`) comes AFTER all of
    `draw_augment_params`'s draws, as in the reference."""
    iw, ih = image_wh
    h = w = input_size
    nw, nh, dx, dy = draw.nw, draw.nh, draw.dx, draw.dy
    box = box.copy()
    xs = [0, 2, 4, 6, 8, 10, 12]
    ys = [1, 3, 5, 7, 9, 11, 13]
    if len(box) > 0:
        rng.shuffle(box)
        box[:, xs] = box[:, xs] * nw / iw + dx
        box[:, ys] = box[:, ys] * nh / ih + dy
        if draw.flip:
            box[:, xs] = w - box[:, [2, 0, 6, 4, 8, 12, 10]]
            box[:, [5, 7, 9, 11, 13]] = box[:, [7, 5, 9, 13, 11]]

        cx = (box[:, 0] + box[:, 2]) / 2
        cy = (box[:, 1] + box[:, 3]) / 2
        keep = (cx > 0) & (cy > 0) & (cx < w) & (cy < h)
        box = box[keep]

        box[:, 0:14][box[:, 0:14] < 0] = 0
        box[:, xs] = np.minimum(box[:, xs], w)
        box[:, ys] = np.minimum(box[:, ys], h)
        bw = box[:, 2] - box[:, 0]
        bh = box[:, 3] - box[:, 1]
        box = box[(bw > 1) & (bh > 1)]

    if len(box) > 0:
        box[:, 4:-1][box[:, -1] == -1] = 0
        box[:, xs] /= w
        box[:, ys] /= h
    return box.astype(np.float32)


def augment_sample(
    image: np.ndarray,  # [H, W, 3] uint8 RGB
    box: np.ndarray,  # [N, 15]
    input_size: int,
    rng: np.random.Generator,
    jitter: float = 0.3,
    hue: float = 0.1,
    sat: float = 1.5,
    val: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference `get_random_data` recipe (utils/dataloader.py:71-149):
    random aspect jitter +-0.3, scale 0.25-3.25, PIL BICUBIC resize, random
    paste on a 128-grey canvas, hflip 0.5 with landmark index remap, HSV
    jitter, box clip/filter > 1 px, normalize coords, zero landmarks where
    flag == -1. Returns (float32 HWC image [not mean-subtracted], [M, 15]
    normalized targets).

    Only the part of the resized image that lands on the canvas is
    computed (byte-identical to resizing all of it and pasting).

    Intentional deviation, as the JAX package's: the reference's
    upper-bound clip `box[:, cols][box[:, cols] > w] = w`
    (utils/dataloader.py:138-139) assigns into a fancy-indexed COPY and is
    a silent no-op, so its boxes can exceed the canvas. This clips for
    real (np.minimum), which only changes boxes the reference left
    overflowing.
    """
    ih, iw = image.shape[:2]
    h = w = input_size
    draw = draw_augment_params(rng, input_size, jitter, hue, sat, val)

    nw, nh = max(draw.nw, 1), max(draw.nh, 1)
    x0, y0 = max(draw.dx, 0), max(draw.dy, 0)  # pasted span on the canvas
    x1, y1 = min(draw.dx + nw, w), min(draw.dy + nh, h)
    canvas = np.full((h, w, 3), 128, np.uint8)
    if x1 > x0 and y1 > y0:
        window = (x0 - draw.dx, y0 - draw.dy, x1 - draw.dx, y1 - draw.dy)
        canvas[y0:y1, x0:x1] = pil_bicubic_resize(image, (nw, nh), window)
    if draw.flip:
        canvas = canvas[:, ::-1]

    rgb = torch.from_numpy(canvas.astype(np.float32))
    image_data = hsv_jitter(rgb, draw.dh * 360, draw.ds, draw.dv).numpy()

    box = transform_boxes(box, draw, (iw, ih), input_size, rng)
    return image_data, box


class WiderFaceDataset:
    """Map-style dataset over a WIDER label.txt (training split).

    `load_image(idx)` decodes one image to uint8 RGB (PIL, imported when
    called: without PIL it raises ImportError); the host loader (`get`)
    and `device_augment.device_train_loader` both decode through it."""

    def __init__(self, txt_path: str, input_size: int, seed: int = 0):
        self.input_size = input_size
        self.imgs_path, self.annos = parse_wider_labels(txt_path)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.imgs_path)

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.imgs_path[index]) as img:
            return np.asarray(img.convert("RGB"), np.uint8)

    def get(self, index: int, rng: np.random.Generator):
        image = self.load_image(index)
        img_data, target = augment_sample(image, self.annos[index], self.input_size, rng)
        return preprocess_input_np(img_data), target


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
