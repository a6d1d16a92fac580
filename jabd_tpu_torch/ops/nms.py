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
"""

from __future__ import annotations

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
