"""Box form conversion and the SSD decode, on torch tensors [..., N, 4].

Port of `point_form`, `decode` and `decode_landm` of
`jabd_tpu/ops/boxes.py`, with the same operation order so that float32
results agree to rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy = boxes[..., :2]
    wh = boxes[..., 2:]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def decode(
    loc: torch.Tensor, priors: torch.Tensor, variances: Tuple[float, float]
) -> torch.Tensor:
    """Loc deltas against cxcywh priors -> corner-form boxes."""
    cxcy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    x1y1 = cxcy - wh / 2
    x2y2 = x1y1 + wh
    return torch.cat([x1y1, x2y2], dim=-1)


def decode_landm(
    pre: torch.Tensor, priors: torch.Tensor, variances: Tuple[float, float]
) -> torch.Tensor:
    """[..., 10] landmark deltas (5 points) -> normalized coords."""
    pts = pre.reshape(*pre.shape[:-1], 5, 2)
    p_cxy = priors[..., None, :2]
    p_wh = priors[..., None, 2:]
    out = p_cxy + pts * variances[0] * p_wh
    return out.reshape(*pre.shape[:-1], 10)
