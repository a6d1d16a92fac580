"""Plain PyTorch greedy NMS: the version the CUDA kernel is held against.

Port of `nms_keep_sorted` / `compact_keep` of `jabd_tpu/ops/nms.py`
(metric `_suppression_row`). Candidates are sorted by descending score;
box i, if still kept, suppresses every strictly-later box j whose metric
exceeds the threshold. The metric is IoU, or DIoU = IoU - (d^2/c^2)^beta1
with the guards union > 0 and c > 0.

This is a Python loop over the valid count, batched over images, with
the operation order of the kernel (`csrc/nms.cu`) so the keep masks agree
bit for bit. The CPU tests and `chip_smoke.py` call it; the serving path
reaches it only for tensors that lie on the CPU (`nms_cuda`).

The rest of the JAX module's family: `nms` (sort, keep mask, compaction
to indices; `nms_cuda.nms` runs it with the kernel), `soft_nms`,
`nms_numpy` (the host's greedy NMS in float64) and `topk_candidates`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
KINDS = ("iou", "diou")


def check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown nms kind: {kind!r} (iou|diou)")


def _metric(bi, boxes, areas, kind: str, beta1: float) -> torch.Tensor:
    """Metric of box i (bi: [B, 4] -> columns [B, 1]) against every box
    ([B, K, 4] with areas [B, K]) -> [B, K]."""
    x1, y1, x2, y2 = (bi[:, c : c + 1] for c in range(4))
    bx1, by1, bx2, by2 = (boxes[..., c] for c in range(4))
    xx1 = torch.maximum(bx1, x1)
    yy1 = torch.maximum(by1, y1)
    xx2 = torch.minimum(bx2, x2)
    yy2 = torch.minimum(by2, y2)
    inter = torch.clamp(xx2 - xx1, min=0.0) * torch.clamp(yy2 - yy1, min=0.0)
    area_i = (x2 - x1) * (y2 - y1)
    union = (areas + area_i) - inter
    one = torch.ones((), dtype=union.dtype, device=union.device)
    metric = inter / torch.where(union > 0, union, one)
    if kind == "iou":
        return metric
    cxi = (x1 + x2) * 0.5
    cyi = (y1 + y2) * 0.5
    dx = cxi - (bx1 + bx2) * 0.5
    dy = cyi - (by1 + by2) * 0.5
    d = dx * dx + dy * dy
    ew = torch.maximum(bx2, x2) - torch.minimum(bx1, x1)
    eh = torch.maximum(by2, y2) - torch.minimum(by1, y1)
    c = ew * ew + eh * eh
    u = d / torch.where(c > 0, c, one)
    # pow(u, 1) is u exactly; the kernel takes the same shortcut.
    return metric - (u if beta1 == 1.0 else torch.pow(u, beta1))


def nms_keep_sorted(
    boxes: torch.Tensor,  # [B, K, 4] float32 corner form, sorted by score
    valid: torch.Tensor,  # [B, K] bool
    iou_threshold: float = 0.45,
    kind: str = "iou",
    beta1: float = 1.0,
) -> torch.Tensor:
    """Exact greedy NMS keep masks [B, K] bool; invalid rows never kept.

    Like the reference, the loop of image b runs over i < sum(valid[b])
    (valid rows are a prefix when the input is score-sorted)."""
    check_kind(kind)
    boxes = boxes.to(torch.float32)
    bsz, k = valid.shape
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    later = torch.arange(k, device=boxes.device)
    n_valid = valid.sum(dim=1)
    keep = valid.clone()
    for i in range(int(n_valid.max()) if bsz else 0):
        metric = _metric(boxes[:, i], boxes, areas, kind, beta1)
        live = keep[:, i : i + 1] & (n_valid > i)[:, None]
        keep &= ~((metric > thr) & (later > i) & live)
    return keep


def compact_keep(keep: torch.Tensor, rows: torch.Tensor, max_out: int):
    """Pack the kept rows ([B, K, D], score order) into [B, max_out, D]
    slots; returns (packed, valid [B, max_out])."""
    bsz, _, dim = rows.shape
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    in_range = keep & (pos < max_out)
    # Dropped rows all land in one spare slot, cut off below.
    slot = torch.where(in_range, pos, torch.full_like(pos, max_out))
    out = rows.new_zeros((bsz, max_out + 1, dim))
    out.scatter_(1, slot[..., None].expand(-1, -1, dim), rows)
    n_out = in_range.sum(dim=1, keepdim=True)
    out_valid = torch.arange(max_out, device=rows.device)[None] < n_out
    return out[:, :max_out], out_valid


def nms(
    boxes: torch.Tensor,  # [N, 4] corner form
    scores: torch.Tensor,  # [N]
    iou_threshold: float = 0.45,
    max_out: int = 750,
    valid: Optional[torch.Tensor] = None,
    kind: str = "iou",
    beta1: float = 1.0,
    keep_fn: Callable = nms_keep_sorted,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed output size: (indices [max_out] into the
    input, in descending score order, valid [max_out]); empty slots point
    at index 0. The order is a stable sort of the masked scores (the lower
    index first among ties), as `jnp.argsort(-masked)`. `keep_fn` computes
    the keep mask of the sorted boxes as [1, N] (`nms_cuda.nms` passes the
    kernel's wrapper)."""
    check_kind(kind)
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device))
    order = torch.sort(-masked, stable=True).indices
    sboxes = boxes.to(torch.float32)[order][None].contiguous()
    keep = keep_fn(sboxes, valid[order][None].contiguous(), iou_threshold, kind, beta1)
    idx, out_valid = compact_keep(keep, order[None, :, None], max_out)
    return idx[0, :, 0], out_valid[0]


def soft_nms(
    boxes: torch.Tensor,  # [N, 4] corner form
    scores: torch.Tensor,  # [N]
    sigma: float = 0.5,
    score_threshold: float = 0.001,
    max_out: int = 750,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian soft-NMS: each step selects the highest current score (the
    first on ties), removes it from the pool and decays every score by
    exp(-iou^2 / sigma); once the selected score falls below
    `score_threshold` the pool is poisoned, so no later step selects.
    Returns (indices [max_out], rescored [max_out], valid [max_out]);
    invalid slots have score 0."""
    n = boxes.shape[0]
    dev = boxes.device
    boxes = boxes.to(torch.float32)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.where(valid, scores.to(torch.float32), neg)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    sel_idx = torch.zeros((max_out,), dtype=torch.int64, device=dev)
    sel_score = torch.full((max_out,), NEG_INF, dtype=torch.float32, device=dev)
    for i in range(min(max_out, n)):
        j = torch.argmax(s)
        sj = s[j]
        sel_idx[i] = j
        sel_score[i] = sj
        metric = _metric(boxes[j][None], boxes[None], areas[None], "iou", 1.0)[0]
        s = s * torch.exp(-(metric**2) / sigma)
        s[j] = NEG_INF
        s = torch.where(sj >= score_threshold, s, neg)
    out_valid = sel_score >= score_threshold
    return sel_idx, torch.where(out_valid, sel_score, torch.zeros_like(sel_score)), out_valid


def nms_numpy(boxes, scores, iou_threshold: float = 0.45, kind: str = "iou", beta1: float = 1.0):
    """Exact greedy NMS on the host, in float64 numpy, for small candidate
    sets whose count varies (the merge of an image pyramid's detections).
    Returns the kept indices in score order (a stable descending sort)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores)
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(boxes[:, 0], boxes[i, 0])
        yy1 = np.maximum(boxes[:, 1], boxes[i, 1])
        xx2 = np.minimum(boxes[:, 2], boxes[i, 2])
        yy2 = np.minimum(boxes[:, 3], boxes[i, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas + areas[i] - inter
        metric = inter / np.where(union > 0, union, 1)
        if kind == "diou":
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            d = (cx - cx[i]) ** 2 + (cy - cy[i]) ** 2
            ex1 = np.minimum(boxes[:, 0], boxes[i, 0])
            ey1 = np.minimum(boxes[:, 1], boxes[i, 1])
            ex2 = np.maximum(boxes[:, 2], boxes[i, 2])
            ey2 = np.maximum(boxes[:, 3], boxes[i, 3])
            c = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
            metric = metric - (d / np.where(c > 0, c, 1)) ** beta1
        sup = metric > iou_threshold
        sup[i] = False
        suppressed |= sup
    return np.asarray(keep, dtype=np.int64)


def topk_candidates(
    boxes: torch.Tensor,  # [N, 4]
    scores: torch.Tensor,  # [N]
    k: int,
    score_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k best scores at or above `score_threshold` (the lower index
    first among ties, as `jax.lax.top_k`): (boxes [k, 4], scores [k],
    valid [k])."""
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    masked = torch.where(scores >= score_threshold, scores, neg)
    top, idx = torch.sort(masked, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    return boxes[idx], top, top > NEG_INF / 2
