"""Anchor <-> ground-truth matching on padded batches, plain PyTorch.

Port of `jabd_tpu/ops/matching.py` (`match_single`, `finish_match`,
`match_batch`) with the batch axis written out in place of vmap. The
matching has two halves:

  front: overlaps[b, g, p] = IoU(truths[b, g], point_form(priors[p])),
         rows of padded GTs set to -1; per prior the best GT (overlap and
         index), per GT the best prior. Ties go to the lowest index
         (torch.argmax returns the first maximum, as jnp.argmax does).
  tail:  the forced match (each valid GT takes its best prior; when two
         GTs pick one prior the LAST one wins, as the reference's Python
         loop does), the threshold, the label / box / landmark lookup and
         the SSD encoding (`finish_match`).

`match_front_plain` is the dense front half: it holds the [B, G, P]
overlap tensor (0.5 GB at B 34, G 128, P 29,126). The CUDA kernel
`csrc/matching.cu` (`ops/matching_cuda.py::match_front`) computes the same
three outputs without it; this function is its oracle and serves CPU
tensors. `match_batch` runs either front half and the shared tail.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from jabd_tpu_torch.ops import boxes as B


class MatchResult(NamedTuple):
    loc_t: torch.Tensor  # [B, P, 4] encoded box targets
    conf_t: torch.Tensor  # [B, P] label per prior: 0 background, else 1 / -1
    landm_t: torch.Tensor  # [B, P, 10] encoded landmark targets
    box_t: torch.Tensor  # [B, P, 4] matched corner-form GT boxes (DIoU loss)


def match_front_plain(
    truths: torch.Tensor,  # [B, G, 4] corner form, padded
    priors: torch.Tensor,  # [P, 4] cxcywh
    valid: torch.Tensor,  # [B, G] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_truth_overlap [B, P] f32, best_truth_idx [B, P] int64,
    best_prior_idx [B, G] int64), with the IoU written component-wise in
    the operation order of `match_single`: inter / (area_t + area_p -
    inter)."""
    px1 = (priors[:, 0] - priors[:, 2] / 2)[None, None]  # [1, 1, P]
    py1 = (priors[:, 1] - priors[:, 3] / 2)[None, None]
    px2 = (priors[:, 0] + priors[:, 2] / 2)[None, None]
    py2 = (priors[:, 1] + priors[:, 3] / 2)[None, None]
    tx1, ty1, tx2, ty2 = (truths[..., i : i + 1] for i in range(4))  # [B, G, 1]
    iw = torch.clamp(torch.minimum(tx2, px2) - torch.maximum(tx1, px1), min=0.0)
    ih = torch.clamp(torch.minimum(ty2, py2) - torch.maximum(ty1, py1), min=0.0)
    inter = iw * ih  # [B, G, P]
    area_t = (tx2 - tx1) * (ty2 - ty1)  # [B, G, 1]
    area_p = (px2 - px1) * (py2 - py1)  # [1, 1, P]
    overlaps = inter / (area_t + area_p - inter)
    overlaps = torch.where(valid[..., None], overlaps, -1.0)
    best_prior_idx = torch.argmax(overlaps, dim=2)  # [B, G]
    best_truth_overlap = torch.amax(overlaps, dim=1)  # [B, P]
    best_truth_idx = torch.argmax(overlaps, dim=1)  # [B, P]
    return best_truth_overlap, best_truth_idx, best_prior_idx


def finish_match(
    threshold: float,
    best_truth_overlap: torch.Tensor,  # [B, P]
    best_truth_idx: torch.Tensor,  # [B, P] int64
    best_prior_idx: torch.Tensor,  # [B, G] int64
    truths: torch.Tensor,  # [B, G, 4]
    priors: torch.Tensor,  # [P, 4]
    variances: Tuple[float, float],
    labels: torch.Tensor,  # [B, G]
    landms: torch.Tensor,  # [B, G, 10]
    valid: torch.Tensor,  # [B, G]
) -> MatchResult:
    """Forced match + threshold + encode, shared by both front halves.

    The forced match is a scatter-max of GT indices into an initial -1:
    on a prior picked by several valid GTs the largest index, the last
    in the reference's loop, wins. The GT-row lookup is an exact gather
    (the JAX package writes it as a one-hot matmul for the TPU)."""
    bsz, num_gt = valid.shape
    gt_ids = torch.arange(num_gt, device=valid.device).expand(bsz, num_gt)
    forced_gt = torch.full_like(best_truth_idx, -1).scatter_reduce(
        1, best_prior_idx, torch.where(valid, gt_ids, -1), "amax", include_self=True
    )
    is_forced = forced_gt >= 0
    idx = torch.where(is_forced, forced_gt, best_truth_idx)
    overlap = torch.where(is_forced, 2.0, best_truth_overlap)

    def pick(table: torch.Tensor) -> torch.Tensor:
        return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))

    matches = pick(truths)
    picked_lms = pick(landms)
    conf = torch.gather(labels, 1, idx)
    conf = torch.where(overlap < threshold, 0.0, conf)

    loc = B.encode(matches, priors, variances)
    landm = B.encode_landm(picked_lms, priors, variances)
    # Background priors get zero targets, so padded or degenerate rows
    # cannot leak a non-finite encoding.
    fg = (conf != 0.0)[..., None]
    return MatchResult(
        loc_t=torch.where(fg, loc, 0.0),
        conf_t=conf,
        landm_t=torch.where(fg, landm, 0.0),
        box_t=torch.where(fg, matches, 0.0),
    )


def match_batch(
    threshold: float,
    truths: torch.Tensor,  # [B, G, 4]
    priors: torch.Tensor,  # [P, 4]
    variances: Tuple[float, float],
    labels: torch.Tensor,  # [B, G]
    landms: torch.Tensor,  # [B, G, 10]
    valid: torch.Tensor,  # [B, G] bool
    front: Callable = match_front_plain,
) -> MatchResult:
    """Match every image of the batch. `front` computes the front half:
    `match_front_plain` or the kernel wrapper `matching_cuda.match_front`."""
    bt_ov, bt_ix, bp_ix = front(truths, priors, valid)
    return finish_match(
        threshold, bt_ov, bt_ix, bp_ix, truths, priors, variances, labels, landms, valid
    )
