"""Recognition data, evaluation half: the face normalization and the
verification-set readers.

Port of `normalize_face`, `load_bin_dataset`, `get_val_pair_memfile`,
`VAL_SET_NAMES` and `load_five_validation_sets` of
`jabd_tpu/recognition/data.py` (the reference's evaluate_utils.py:11-57
and data.py:263). An insightface `.bin` is a pickled (encoded images,
issame) pair; the port decodes its JPEGs with PIL (as `cv2.imdecode`
decodes them, `eval/run_wider.decode_bgr`) and resizes an off-size image
to 112 with `ops/image.resize_np` (cv2's INTER_LINEAR, within 1 grey level
of it). The training augmentation and `ImageFolderDataset` come with the
recognition training slice.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

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
