"""Resize and adaptive average pooling on NCHW tensors.

Port of `resize` / `adaptive_avg_pool` of `jabd_tpu/ops/resize.py`. The
JAX package builds per-axis interpolation matrices with torch semantics
(bicubic A = -0.75, `align_corners=True` index mapping, nearest as
floor(i * in / out), adaptive bins [floor(i*in/out), ceil((i+1)*in/out)))
so that XLA can run them as matmuls; here the same maps are the torch
operators those matrices were written to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    mode: str = "nearest",
    align_corners: bool = True,
) -> torch.Tensor:
    """F.interpolate of NCHW x to (H', W'); a no-op at the same size."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(out_hw), mode="nearest")
    if mode in ("bilinear", "bicubic"):
        return F.interpolate(
            x, size=tuple(out_hw), mode=mode, align_corners=align_corners
        )
    raise ValueError(f"unknown resize mode {mode!r}")


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d on NCHW x."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))
