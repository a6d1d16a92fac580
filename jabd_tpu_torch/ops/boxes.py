"""Box geometry and the SSD codec, on torch tensors [..., N, 4].

Port of `point_form`, `intersect`, `area`, `jaccard`,
`iou_pairwise_general`, `elementwise_diou`,
`encode`, `decode`, `encode_landm`, `decode_landm` and `log_sum_exp` of
`jabd_tpu/ops/boxes.py`, with the same operation order so that float32
results agree to rounding.
"""

from __future__ import annotations

import math
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


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area of corner-form boxes:
    [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    inter = torch.clamp(max_xy - min_xy, min=0.0)
    return inter[..., 0] * inter[..., 1]


def area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., A, B] of corner-form boxes."""
    inter = intersect(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    return inter / union


def iou_pairwise_general(box_a: torch.Tensor, box_b: torch.Tensor, kind: str = "iou") -> torch.Tensor:
    """Pairwise IoU / GIoU / DIoU / CIoU matrix [..., A, B] of corner-form
    boxes (utils/box_utils.py:5-158, bbox_overlaps_{iou,giou,diou,ciou})."""
    inter = intersect(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    iou = inter / union
    if kind == "iou":
        return iou

    enc_min = torch.minimum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    enc_max = torch.maximum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    enc_wh = torch.clamp(enc_max - enc_min, min=0.0)
    if kind == "giou":
        enc_area = enc_wh[..., 0] * enc_wh[..., 1]
        return iou - (enc_area - union) / torch.clamp(enc_area, min=1e-7)

    ctr_a = (box_a[..., :2] + box_a[..., 2:]) / 2
    ctr_b = (box_b[..., :2] + box_b[..., 2:]) / 2
    d2 = torch.sum((ctr_a[..., :, None, :] - ctr_b[..., None, :, :]) ** 2, dim=-1)
    c2 = torch.sum(enc_wh**2, dim=-1)
    diou = iou - d2 / torch.clamp(c2, min=1e-7)
    if kind == "diou":
        return diou
    if kind == "ciou":
        wh_a = (box_a[..., 2:] - box_a[..., :2])[..., :, None, :]
        wh_b = (box_b[..., 2:] - box_b[..., :2])[..., None, :, :]
        v = (4 / math.pi**2) * (
            torch.atan(wh_a[..., 0] / torch.clamp(wh_a[..., 1], min=1e-7))
            - torch.atan(wh_b[..., 0] / torch.clamp(wh_b[..., 1], min=1e-7))
        ) ** 2
        alpha = v / torch.clamp(1 - iou + v, min=1e-7)
        return diou - alpha * v
    raise ValueError(f"unknown iou kind {kind!r}")


def elementwise_diou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """DIoU of matched corner-form box pairs, [..., 4] x [..., 4] -> [...]
    (the DIoU regression loss, retinaface_training_DIOU.py:491-522)."""
    max_xy = torch.minimum(boxes_a[..., 2:], boxes_b[..., 2:])
    min_xy = torch.maximum(boxes_a[..., :2], boxes_b[..., :2])
    inter_wh = torch.clamp(max_xy - min_xy, min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = area(boxes_a) + area(boxes_b) - inter
    iou = inter / torch.clamp(union, min=1e-7)

    enc_min = torch.minimum(boxes_a[..., :2], boxes_b[..., :2])
    enc_max = torch.maximum(boxes_a[..., 2:], boxes_b[..., 2:])
    enc_wh = torch.clamp(enc_max - enc_min, min=0.0)
    c2 = torch.sum(enc_wh**2, dim=-1)
    ctr_a = (boxes_a[..., :2] + boxes_a[..., 2:]) / 2
    ctr_b = (boxes_b[..., :2] + boxes_b[..., 2:]) / 2
    d2 = torch.sum((ctr_a - ctr_b) ** 2, dim=-1)
    return iou - d2 / torch.clamp(c2, min=1e-7)


def encode(
    matched: torch.Tensor, priors: torch.Tensor, variances: Tuple[float, float]
) -> torch.Tensor:
    """Matched corner-form boxes against cxcywh priors -> loc targets.
    Widths below 1e-12 of the prior's are clamped before the log, so a
    degenerate (zero-area) box gives a finite target."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(torch.clamp(g_wh, min=1e-12)) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def encode_landm(
    matched: torch.Tensor, priors: torch.Tensor, variances: Tuple[float, float]
) -> torch.Tensor:
    """[..., 10] landmark coords (5 points) against priors."""
    pts = matched.reshape(*matched.shape[:-1], 5, 2)
    p_cxy = priors[..., None, :2]
    p_wh = priors[..., None, 2:]
    g = (pts - p_cxy) / (variances[0] * p_wh)
    return g.reshape(*matched.shape[:-1], 10)


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x))) over the last axis, keepdim, shifted by the max
    (`amax`: on ties its gradient is shared, as jnp.max's is)."""
    x_max = torch.amax(x, dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(x - x_max), dim=-1, keepdim=True)) + x_max
