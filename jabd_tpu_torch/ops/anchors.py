"""Anchor (prior box) generation, numpy, memoised per (config, size).

Port of `jabd_tpu/ops/anchors.py`: for level k with step s and feature
map (fh, fw) = (ceil(H/s), ceil(W/s)), cells row-major over (i, j) and
the min-sizes innermost, anchor = ((j + 0.5) s / W, (i + 0.5) s / H,
m / W, m / H). Output float32 [N, 4] normalized cxcywh.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from jabd_tpu_torch.configs import AnchorConfig


def feature_map_shapes(
    cfg: AnchorConfig, image_size: Tuple[int, int]
) -> Tuple[Tuple[int, int], ...]:
    """(ceil(H/step), ceil(W/step)) per level."""
    h, w = image_size
    return tuple(
        (math.ceil(h / step), math.ceil(w / step)) for step in cfg.steps
    )


def num_anchors(cfg: AnchorConfig, image_size: Tuple[int, int]) -> int:
    return sum(
        fh * fw * len(ms)
        for (fh, fw), ms in zip(feature_map_shapes(cfg, image_size), cfg.min_sizes)
    )


@functools.lru_cache(maxsize=64)
def generate_anchors(
    cfg: AnchorConfig, image_size: Tuple[int, int]
) -> np.ndarray:
    """Full anchor set for `image_size` = (H, W): read-only float32 [N, 4]."""
    h, w = image_size
    out = []
    for (fh, fw), step, min_sizes in zip(
        feature_map_shapes(cfg, image_size), cfg.steps, cfg.min_sizes
    ):
        m = np.asarray(min_sizes, dtype=np.float64)  # [A]
        cy, cx = np.meshgrid(
            (np.arange(fh, dtype=np.float64) + 0.5) * step / h,
            (np.arange(fw, dtype=np.float64) + 0.5) * step / w,
            indexing="ij",
        )  # [fh, fw]
        level = np.empty((fh, fw, len(min_sizes), 4), dtype=np.float64)
        level[..., 0] = cx[:, :, None]
        level[..., 1] = cy[:, :, None]
        level[..., 2] = (m / w)[None, None, :]
        level[..., 3] = (m / h)[None, None, :]
        out.append(level.reshape(-1, 4))
    anchors = np.concatenate(out, axis=0).astype(np.float32)
    if cfg.clip:
        anchors = np.clip(anchors, 0.0, 1.0)
    anchors.setflags(write=False)
    return anchors
