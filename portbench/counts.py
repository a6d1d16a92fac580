"""The yardstick's arithmetic: the card's peaks, the operations and bytes
the two hand-written kernels' inputs need, and the model FLOPs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.

K1 (greedy NMS over score-sorted candidates, `csrc/nms.cu`) and K2 (the
front half of anchor matching, `csrc/matching.cu`): frozen copies of
`chip_smoke.py`'s `nms_ops` and `match_ops` and of its byte counts. The
operations are what the inputs need whatever implements them: one IoU
(14 operations) per (kept i, later valid j) of each image, from an exact
greedy NMS of the reference's candidates; 13 per (valid GT, prior) in a
1024-prior tile whose bounding box the GT meets plus 8 per (valid GT,
tile). Bytes count each input read once and each output written once.

FLOPs: convolutions and matrix products of the float32 reference model,
counted by torch's FlopCounterMode on the meta device at the cell's shape
(forward; forward and backward for a training step), so that a later
change of the served program's kernels cannot change the count.
"""

from __future__ import annotations

import torch

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

IOU_OPS = 14
MATCH_OPS = 13
CULL_OPS = 8
MATCH_TILE = 1024


def nms_ops(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """Operations of greedy IoU NMS on score-sorted [B, K] candidates:
    IOU_OPS per (kept i, later valid j)."""
    n_valid = valid.sum(1, keepdim=True)
    pos = torch.arange(keep.shape[1], device=keep.device)[None]
    return IOU_OPS * int(torch.where(keep, n_valid - 1 - pos, 0).sum())


def nms_bytes(bsz: int, k: int) -> int:
    """Boxes (float32 x 4) and valid (1 byte) read, keep (1 byte) written."""
    return bsz * k * (16 + 1 + 1)


def match_ops(truths: torch.Tensor, valid: torch.Tensor, priors: torch.Tensor, tile: int = MATCH_TILE) -> int:
    """Operations of the matching front half for [B, G, 4] corner truths,
    [B, G] valid and [P, 4] (cx, cy, w, h) priors."""
    p = priors.shape[0]
    ntiles = -(-p // tile)
    corners = torch.cat([priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], 1)
    pad = torch.tensor([[float("inf")] * 2 + [float("-inf")] * 2], device=priors.device).expand(ntiles * tile - p, 4)
    corners = torch.cat([corners, pad]).view(ntiles, tile, 4)
    lo, hi = corners[..., :2].amin(1), corners[..., 2:].amax(1)
    t = truths[:, :, None, :]
    meets = ((torch.minimum(t[..., 2:], hi) - torch.maximum(t[..., :2], lo)) > 0).all(-1) & valid[:, :, None]
    sizes = torch.full((ntiles,), tile, device=priors.device)
    sizes[-1] = p - (ntiles - 1) * tile
    return MATCH_OPS * int((meets * sizes).sum()) + CULL_OPS * int(valid.sum()) * ntiles


def match_bytes(bsz: int, g: int, p: int) -> int:
    """Truths, valid and priors read; per prior the best overlap (float32)
    and index (int64), per GT the best prior (int64) written."""
    return bsz * g * (16 + 1) + p * 16 + bsz * p * (4 + 8) + bsz * g * 8


def bound_s(ops: int, nbytes: int, flops: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)


def model_flops(model_fn, shape, backward: bool) -> int:
    """FLOPs of `model_fn()`'s module on a meta input of `shape` (NCHW),
    with its backward when `backward`."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = model_fn()
        x = torch.empty(shape)
    counter = FlopCounterMode(display=False)
    with counter:
        out = model(x)
        if backward:
            sum(o.sum() for o in out).backward()
    return int(counter.get_total_flops())
