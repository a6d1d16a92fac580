"""Synthetic data for the learning proofs of the PyTorch port
(`scripts/torch_*.py`): bright squares as faces, smooth patterns as
identities, nothing to download.

Each generator makes the numpy draws of its JAX-package twin in the same
order, so one seed gives the same arrays, label lines and ground truth:

* `make_batch`: scripts/overfit_sanity.py::make_batch;
* `build_dataset`: scripts/overfit_device_augment.py::build_dataset, and
  `clean_canvases` the held-out canvases of that script's main;
* `build_tree`: scripts/train_at_scale.py::build_tree. cv2.imwrite there,
  PIL here at cv2's default JPEG quality (95): the label lines and ground
  truth are equal, the decoded pixels as far as two JPEG encoders round
  apart;
* `identity_base`, `render_float` and `make_identity_batch`:
  scripts/overfit_recognition.py; `render`, `build_identity_tree` and
  `build_val_bundle`: scripts/train_recognition_at_scale.py;
* `write_gt_mats`: the WIDER evaluator's .mat ground truth, in the
  official nested cell layout.

numpy, with PIL and scipy imported where used: no jax, no cv2, nothing of
the JAX package or of tests/.
"""

from __future__ import annotations

import os

import numpy as np

MEANS_BGR = np.asarray([104, 117, 123], np.float32)
NO_LANDMARKS = " ".join(["-1.0 -1.0 -1.0"] * 5)


def make_batch(rng, n: int, size: int = 128, g: int = 4):
    """Grey canvases [n, size, size, 3] (mean-subtracted float32) with 1-2
    bright squares each, their boxes [n, g, 4] (normalized corners) and
    valid flags [n, g]."""
    imgs = np.full((n, size, size, 3), 30.0, np.float32)
    boxes = np.zeros((n, g, 4), np.float32)
    valid = np.zeros((n, g), bool)
    for i in range(n):
        for j in range(int(rng.integers(1, 3))):
            s = int(rng.integers(24, 48))
            x = int(rng.integers(0, size - s))
            y = int(rng.integers(0, size - s))
            imgs[i, y : y + s, x : x + s] = rng.uniform(150, 230)
            boxes[i, j] = [x / size, y / size, (x + s) / size, (y + s) / size]
            valid[i, j] = True
    imgs -= MEANS_BGR
    return imgs, boxes, valid


def build_dataset(root: str, n: int, rng) -> str:
    """A WIDER label.txt tree of n grey JPEGs (120-219 x 140-255) with 1-2
    bright squares each; returns the label.txt path."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = int(rng.integers(120, 220)), int(rng.integers(140, 256))
        img = np.full((h, w, 3), 30, np.uint8)
        lines.append(f"# img_{i}.jpg")
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(max(24, min(h, w) // 6), min(h, w) // 2))
            x = int(rng.integers(0, w - s))
            y = int(rng.integers(0, h - s))
            img[y : y + s, x : x + s] = int(rng.uniform(150, 230))
            lines.append(f"{x} {y} {s} {s} {NO_LANDMARKS} 1.0")
        Image.fromarray(img).save(os.path.join(root, "images", f"img_{i}.jpg"), quality=95)
    path = os.path.join(root, "label.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def clean_canvases(rng, n: int = 16, size: int = 128):
    """Unaugmented held-out canvases (mean-subtracted float32) with 1-2
    squares of 24-55 px, and each canvas's [k, 4] pixel corner boxes."""
    imgs = np.full((n, size, size, 3), 30.0, np.float32)
    gt_boxes = []
    for i in range(n):
        boxes = []
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(24, 56))
            x = int(rng.integers(0, size - s))
            y = int(rng.integers(0, size - s))
            imgs[i, y : y + s, x : x + s] = rng.uniform(150, 230)
            boxes.append([x, y, x + s, y + s])
        gt_boxes.append(np.asarray(boxes, np.float32))
    imgs -= MEANS_BGR
    return imgs, gt_boxes


def build_tree(root: str, n: int, rng, subdir: str = "images", src_scale: float = 1.0):
    """A WIDER label.txt tree of n noisy grey JPEGs with 1-3 bright squares
    each, sides (240-479, 280-559) times src_scale. Returns (label.txt
    path, {stem: [[x, y, w, h], ...]}). The arrays are BGR, as cv2 writes
    them: PIL is given the channels reversed, so a BGR decoder reads them
    back."""
    from PIL import Image

    os.makedirs(os.path.join(root, subdir), exist_ok=True)
    lines = []
    gt = {}
    for i in range(n):
        h = int(rng.integers(240, 480) * src_scale)
        w = int(rng.integers(280, 560) * src_scale)
        img = np.full((h, w, 3), 30, np.uint8)
        img += rng.integers(0, 12, (h, w, 3), np.uint8)  # mild noise
        name = f"img_{i}.jpg"
        lines.append(f"# {name}")
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            s = int(rng.integers(max(28, min(h, w) // 8), min(h, w) // 3))
            x = int(rng.integers(0, w - s))
            y = int(rng.integers(0, h - s))
            img[y : y + s, x : x + s] = int(rng.uniform(150, 230))
            lines.append(f"{x} {y} {s} {s} {NO_LANDMARKS} 1.0")
            boxes.append([x, y, s, s])
        gt[f"img_{i}"] = boxes
        Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(
            os.path.join(root, subdir, name), quality=95
        )
    path = os.path.join(root, "label.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, gt


def write_gt_mats(root: str, events) -> str:
    """wider_face_val.mat and the easy / medium / hard mats, in the
    official nested cell layout, for events = {event: {stem: [N, 4] x y w
    h}} (every face kept in every setting). scipy, imported here."""
    from scipy.io import savemat

    e = len(events)
    event_list, file_list, box_list, keep_list = (np.empty((e, 1), object) for _ in range(4))
    for i, (event, imgs) in enumerate(events.items()):
        event_list[i, 0] = event
        files, boxes, keeps = (np.empty((len(imgs), 1), object) for _ in range(3))
        for j, (stem, gt) in enumerate(imgs.items()):
            files[j, 0] = stem
            boxes[j, 0] = np.asarray(gt, float).reshape(-1, 4)
            keeps[j, 0] = np.arange(1, len(gt) + 1).reshape(-1, 1)
        file_list[i, 0], box_list[i, 0], keep_list[i, 0] = files, boxes, keeps
    os.makedirs(root, exist_ok=True)
    savemat(os.path.join(root, "wider_face_val.mat"),
            {"face_bbx_list": box_list, "event_list": event_list, "file_list": file_list})
    for name in ("easy", "medium", "hard"):
        savemat(os.path.join(root, f"wider_{name}_val.mat"), {"gt_list": keep_list})
    return root


def identity_base(identity: int) -> np.ndarray:
    """A deterministic 112x112 'face' per identity: an 8x8 random grid
    upsampled 14x (float32)."""
    r = np.random.default_rng(1000 + identity)
    coarse = r.uniform(40, 215, (8, 8, 3)).astype(np.float32)
    return np.kron(coarse, np.ones((14, 14, 1), np.float32))


def render_float(base: np.ndarray, rng) -> np.ndarray:
    """One 'photo' of an identity as the overfit draws it: brightness and
    contrast jitter, a translation of up to 8 px, pixel noise, a random
    horizontal flip; float32 in [0, 255]."""
    img = base.copy()
    img = img * rng.uniform(0.8, 1.2) + rng.uniform(-20, 20)
    dx, dy = rng.integers(-8, 9, size=2)
    img = np.roll(img, (dy, dx), axis=(0, 1))
    img += rng.normal(0, 8, img.shape)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.clip(img, 0, 255)


def make_identity_batch(rng, bases, batch: int):
    """(images [batch, 112, 112, 3] in [-1, 1], labels [batch]) of random
    identities among `bases`."""
    labels = rng.integers(0, len(bases), size=batch)
    imgs = np.stack([render_float(bases[int(c)], rng) for c in labels])
    return (imgs / 255.0 - 0.5) / 0.5, labels


def render(base: np.ndarray, rng) -> np.ndarray:
    """The at-scale scripts' 'photo': the same jitter as `render_float`
    with the noise added in float64, as uint8."""
    img = base * rng.uniform(0.8, 1.2) + rng.uniform(-20, 20)
    dx, dy = rng.integers(-8, 9, size=2)
    img = np.roll(img, (dy, dx), axis=(0, 1))
    img = img + rng.normal(0, 8, img.shape)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.clip(img, 0, 255).astype(np.uint8)


def build_identity_tree(root: str, rng, ids: int, per_id: int) -> list:
    """An ImageFolder tree root/id_<i>/<k>.jpg of `ids` identities x
    `per_id` renders (PIL, quality 95); returns the identities' bases."""
    from PIL import Image

    bases = [identity_base(i) for i in range(ids)]
    for i, base in enumerate(bases):
        d = os.path.join(root, f"id_{i:03d}")
        os.makedirs(d, exist_ok=True)
        for k in range(per_id):
            Image.fromarray(render(base, rng)).save(os.path.join(d, f"{k}.jpg"), quality=95)
    return bases


def build_val_bundle(root: str, bases, rng, pairs: int = 120) -> None:
    """Held-out verification pairs in the production memfile layout
    (root/lfw/memfile/lfw.npy, root/lfw_list.npy): 2 * pairs pairs, even
    ones two fresh renders of one identity, odd ones of two."""
    ids = len(bases)
    size = bases[0].shape[0]
    n = 2 * pairs
    data = np.zeros((2 * n, size, size, 3), np.uint8)
    issame = np.zeros(n, bool)
    for p in range(n):
        if p % 2 == 0:  # genuine
            i = int(rng.integers(0, ids))
            a, b = render(bases[i], rng), render(bases[i], rng)
            issame[p] = True
        else:  # impostor
            i, j = rng.choice(ids, size=2, replace=False)
            a, b = render(bases[int(i)], rng), render(bases[int(j)], rng)
        data[2 * p], data[2 * p + 1] = a, b
    os.makedirs(os.path.join(root, "lfw", "memfile"), exist_ok=True)
    np.save(os.path.join(root, "lfw", "memfile", "lfw.npy"), data)
    np.save(os.path.join(root, "lfw_list.npy"), issame)
