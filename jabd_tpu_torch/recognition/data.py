"""Recognition data: the AdaFace training augmentation, the class-folder
training set and its loader, the face normalization and the
verification-set readers.

Port of `jabd_tpu/recognition/data.py` (the reference's data.py:166-333,
evaluate_utils.py:11-57). The augmentation (zero-padded random resized
crop, low-res down-up resampling, PIL ColorJitter) is drawn first
(`draw_face_augment_params`, the same numpy RNG consumption as the JAX
package, so the device plans of `recognition/device_augment.py` see the
same draws) and then applied on the host (`apply_face_augment`).

Without cv2: the low-res step resizes with the 1-D operators of
`device_augment.cv2_resize_matrix` (cv2's float semantics for its five
modes), one resize at a time, each rounded and saturated to uint8 as
cv2 does. cv2 resizes uint8 in fixed point, so with a low-res draw the
pixels differ from the JAX package's host path by a few grey levels
(tests/test_torch_port_recognition_augment.py records them per mode);
every other step is byte-exact. The photometric jitter is PIL's
ImageEnhance arithmetic in numpy (`color_jitter_pil`).

An insightface `.bin` is a pickled (encoded images, issame) pair; the port
decodes its JPEGs with PIL (as `cv2.imdecode` decodes them,
`eval/run_wider.decode_bgr`) and resizes an off-size image to 112 with
`ops/image.resize_np` (cv2's INTER_LINEAR, within 1 grey level of it), as
it resizes an off-size training image.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import pickle
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# cv2 interpolation ids in the reference's draw order (data.py:323-325):
# NEAREST, LINEAR, AREA, CUBIC, LANCZOS4.
CV2_INTERPS = (0, 1, 3, 2, 4)


class FaceAugmentDraw(NamedTuple):
    """One drawn face augmentation (crop -> low-res -> photometric).

    crop:   (i, ch, j, cw) rectangle kept in place (the rest zeroed), or None
    lowres: (small_side, interp_down, interp_up) cv2 ids, or None
    photo:  (brightness, contrast, saturation) in [0.5, 1.5], or None
    photo_order: the ColorJitter op order (a permutation of 0 brightness,
            1 contrast, 2 saturation)
    score:  crop_ratio * resize_ratio (AdaFace's quality proxy)
    """

    crop: Optional[Tuple[int, int, int, int]]
    lowres: Optional[Tuple[int, int, int]]
    photo: Optional[Tuple[float, float, float]]
    photo_order: Tuple[int, int, int]
    score: float


def draw_face_augment_params(
    rng: np.random.Generator,
    h: int,
    w: int,
    crop_prob: float = 0.2,
    low_res_prob: float = 0.2,
    photometric_prob: float = 0.2,
) -> FaceAugmentDraw:
    """Draw one augmentation from `rng`, consuming it exactly as the JAX
    package's `draw_face_augment_params` does: RandomResizedCrop (scale
    0.2-1, ratio 3/4-4/3, 10 tries), the low-res side and two cv2 modes,
    then ColorJitter's op permutation and its three factors."""
    crop = None
    crop_ratio = 1.0
    if rng.random() < crop_prob:
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(0.2, 1.0)
            aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = int(rng.integers(0, h - ch + 1))
                j = int(rng.integers(0, w - cw + 1))
                crop = (i, ch, j, cw)
                crop_ratio = min(ch, cw) / max(h, w)
                break
    lowres = None
    resize_ratio = 1.0
    if rng.random() < low_res_prob:
        side_ratio = rng.uniform(0.2, 1.0)
        small_side = int(side_ratio * h)
        down = CV2_INTERPS[rng.integers(len(CV2_INTERPS))]
        up = CV2_INTERPS[rng.integers(len(CV2_INTERPS))]
        lowres = (small_side, int(down), int(up))
        resize_ratio = side_ratio
    photo = None
    photo_order = (0, 1, 2)
    if rng.random() < photometric_prob:
        photo_order = tuple(int(i) for i in rng.permutation(3))
        photo = (
            float(rng.uniform(0.5, 1.5)),
            float(rng.uniform(0.5, 1.5)),
            float(rng.uniform(0.5, 1.5)),
        )
    return FaceAugmentDraw(crop, lowres, photo, photo_order, resize_ratio * crop_ratio)


def resize_u8(img: np.ndarray, size_wh: Tuple[int, int], interp: int) -> np.ndarray:
    """`cv2.resize(img, size_wh, interpolation=interp)` of a uint8 HWC
    image through cv2's float operators (`cv2_resize_matrix`, rows then
    columns in float64), rounded half to even and saturated to uint8."""
    from jabd_tpu_torch.recognition.device_augment import cv2_resize_matrix

    w, h = size_wh
    mv = cv2_resize_matrix(img.shape[0], h, interp).astype(np.float64)
    mh = cv2_resize_matrix(img.shape[1], w, interp).astype(np.float64)
    y = np.einsum("rh,hwc->rwc", mv, img.astype(np.float64))
    y = np.einsum("ow,rwc->roc", mh, y)
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def low_res_augmentation(img: np.ndarray, rng: np.random.Generator):
    """Down-up-sample with a random pair of cv2 modes (data.py:322-333):
    (image, side_ratio). The JAX package's draws, applied by
    `apply_face_augment`."""
    side_ratio = rng.uniform(0.2, 1.0)
    down = CV2_INTERPS[rng.integers(len(CV2_INTERPS))]
    up = CV2_INTERPS[rng.integers(len(CV2_INTERPS))]
    draw = FaceAugmentDraw(None, (int(side_ratio * img.shape[0]), down, up), None, (0, 1, 2), side_ratio)
    return apply_face_augment(img, draw), side_ratio


def apply_face_augment(img: np.ndarray, draw: FaceAugmentDraw) -> np.ndarray:
    """Apply a drawn augmentation on the host: crop-zeroing, the two uint8
    resizes of a low-res draw, the PIL ColorJitter."""
    if draw.crop is not None:
        i, ch, j, cw = draw.crop
        new = np.zeros_like(img)
        new[i : i + ch, j : j + cw] = img[i : i + ch, j : j + cw]
        img = new
    if draw.lowres is not None:
        small_side, down, up = draw.lowres
        small = resize_u8(img, (small_side, small_side), down)
        img = resize_u8(small, (img.shape[1], img.shape[0]), up)
    if draw.photo is not None:
        img = color_jitter_pil(img.astype(np.uint8), draw.photo, draw.photo_order)
    return img.astype(np.uint8)


def _pil_gray(img_u8: np.ndarray) -> np.ndarray:
    """PIL Image.convert("L"), byte-exact: ITU-R 601 luma in PIL's fixed
    point, (r*19595 + g*38470 + b*7471 + 0x8000) >> 16."""
    r = img_u8[..., 0].astype(np.uint32)
    g = img_u8[..., 1].astype(np.uint32)
    b = img_u8[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _pil_blend(degenerate: np.ndarray, img: np.ndarray, factor: float):
    """PIL ImageEnhance's blend: interpolate toward the degenerate image
    (float64 here), truncate, clip to uint8."""
    out = degenerate.astype(np.float64) + factor * (img.astype(np.float64) - degenerate.astype(np.float64))
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def color_jitter_pil(
    img_u8: np.ndarray,
    factors: Tuple[float, float, float],
    order: Tuple[int, int, int] = (0, 1, 2),
) -> np.ndarray:
    """torchvision ColorJitter(brightness, contrast, saturation) on a PIL
    image, in `order`: brightness blends toward black, contrast toward the
    solid grey of the L image's rounded mean, saturation toward the L
    image; each op rounds down to uint8."""
    b, c, s = factors
    for op in order:
        if op == 0:
            img_u8 = _pil_blend(np.zeros_like(img_u8), img_u8, b)
        elif op == 1:
            mean = int(_pil_gray(img_u8).mean() + 0.5)
            img_u8 = _pil_blend(np.full_like(img_u8, mean), img_u8, c)
        else:
            gray3 = np.repeat(_pil_gray(img_u8)[..., None], 3, axis=2)
            img_u8 = _pil_blend(gray3, img_u8, s)
    return img_u8


def augment_face(
    img: np.ndarray,
    rng: np.random.Generator,
    crop_prob: float = 0.2,
    low_res_prob: float = 0.2,
    photometric_prob: float = 0.2,
) -> Tuple[np.ndarray, float]:
    """AdaFace's training augmentation (data.py:217-260): (augmented uint8
    image, information score crop_ratio * resize_ratio)."""
    h, w = img.shape[:2]
    draw = draw_face_augment_params(rng, h, w, crop_prob, low_res_prob, photometric_prob)
    return apply_face_augment(img, draw), draw.score

VAL_SET_NAMES = ("agedb_30", "cfp_fp", "lfw", "cplfw", "calfw")


def normalize_face(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 in [-1, 1] (the 0.5/0.5 transform)."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def resize_face(bgr: np.ndarray, size: int = 112) -> np.ndarray:
    """`cv2.resize(bgr, (size, size))` (INTER_LINEAR) of a uint8 image,
    unless it has that size already."""
    if bgr.shape[:2] == (size, size):
        return bgr
    from jabd_tpu_torch.ops.image import resize_np

    return resize_np(bgr, (size, size)).astype(np.uint8)


def sample_rng(seed: int, idx: int) -> np.random.Generator:
    """The per-sample RNG of both training loaders."""
    return np.random.default_rng((seed * 1_000_003 + int(idx) * 7919) & 0x7FFFFFFF)


def decode_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageFolderDataset:
    """Class-per-directory training set with the AdaFace augmentation (the
    reference's CustomImageFolderDataset, data.py:166-260).

    root/<class>/<image>; labels are contiguous ints in sorted class-name
    order (torchvision's ImageFolder). `swap_color_channel` swaps RGB to
    BGR (the reference's WebFace quirk, data.py:205-207)."""

    def __init__(
        self,
        root: str,
        swap_color_channel: bool = False,
        crop_prob: float = 0.2,
        low_res_prob: float = 0.2,
        photometric_prob: float = 0.2,
        output_size: int = 112,
    ):
        self.root = root
        self.swap_color_channel = swap_color_channel
        self.crop_prob = crop_prob
        self.low_res_prob = low_res_prob
        self.photometric_prob = photometric_prob
        self.output_size = output_size
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
        for c in classes:
            d = os.path.join(root, c)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(exts):
                    self.samples.append((os.path.join(d, f), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    def load(self, index: int) -> Tuple[np.ndarray, int]:
        """(decoded uint8 RGB image at output_size, label): the host work
        both loaders share."""
        path, label = self.samples[index]
        img = decode_rgb(path)
        if self.swap_color_channel:
            img = img[:, :, ::-1]
        return np.ascontiguousarray(resize_face(img, self.output_size)), label

    def get(self, index: int, rng: np.random.Generator):
        """(augmented, flipped-or-not, normalized float32 image, label)."""
        img, label = self.load(index)
        img, _score = augment_face(
            img, rng, crop_prob=self.crop_prob, low_res_prob=self.low_res_prob,
            photometric_prob=self.photometric_prob,
        )
        if rng.random() < 0.5:  # RandomHorizontalFlip
            img = img[:, ::-1]
        return normalize_face(img), label


def epoch_order(n: int, batch_size: int, seed: int, drop_last: bool = True):
    """The index batches of one epoch: a permutation from `seed`, cut into
    batches (the tail kept unless drop_last)."""
    order = np.random.default_rng(seed).permutation(n)
    cursor = 0
    while cursor + batch_size <= n or (not drop_last and cursor < n):
        yield order[cursor : cursor + batch_size]
        cursor += batch_size


def recognition_train_loader(
    dataset: ImageFolderDataset,
    batch_size: int,
    seed: int = 0,
    num_workers: int = 8,
    drop_last: bool = True,
):
    """A shuffled epoch of (images [B, S, S, 3] float32, labels [B] int32),
    each sample augmented on a worker thread from its own RNG
    (`sample_rng(seed, idx)`)."""
    pool = cf.ThreadPoolExecutor(max_workers=num_workers)
    try:
        for idxs in epoch_order(len(dataset), batch_size, seed, drop_last):
            results = list(pool.map(lambda idx: dataset.get(int(idx), sample_rng(seed, idx)), idxs))
            images = np.stack([r[0] for r in results]).astype(np.float32)
            labels = np.asarray([r[1] for r in results], np.int32)
            yield images, labels
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def load_bin_dataset(path: str, image_size: int = 112):
    """An insightface verification .bin -> ([N, S, S, 3] RGB uint8, [N/2]
    bool issame), without mxnet."""
    from jabd_tpu_torch.eval.run_wider import decode_bgr

    with open(path, "rb") as f:
        bins, issame_list = pickle.load(f, encoding="bytes")
    data = np.zeros((len(bins), image_size, image_size, 3), np.uint8)
    for i, b in enumerate(bins):
        raw = b if isinstance(b, (bytes, bytearray)) else np.asarray(b).tobytes()
        data[i] = resize_face(decode_bgr(raw), image_size)[:, :, ::-1]  # RGB
    return data, np.asarray(issame_list, bool)


def get_val_pair_memfile(data_dir: str, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Memmap validation loader: `{name}/memfile/{name}.npy` and the issame
    list `{name}_list.npy` (recognition/convert.bin_to_memfile's layout)."""
    mem_path = os.path.join(data_dir, name, "memfile", f"{name}.npy")
    issame_path = os.path.join(data_dir, f"{name}_list.npy")
    return np.load(mem_path, mmap_mode="r"), np.load(issame_path)


def load_five_validation_sets(data_dir: str) -> Dict[str, tuple]:
    """The 5-set validation bundle (agedb_30, cfp_fp, lfw, cplfw, calfw),
    each from its `.bin` or its memfile; sets not on disk are skipped."""
    out = {}
    for name in VAL_SET_NAMES:
        bin_path = os.path.join(data_dir, f"{name}.bin")
        mem_path = os.path.join(data_dir, name, "memfile", f"{name}.npy")
        if os.path.exists(bin_path):
            out[name] = load_bin_dataset(bin_path)
        elif os.path.exists(mem_path):
            out[name] = get_val_pair_memfile(data_dir, name)
    return out
