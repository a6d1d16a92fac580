"""MultiBox loss with dense matching and sort-based hard-negative mining.

Port of `jabd_tpu/losses.py` (`Targets`, `smooth_l1`, `multibox_loss`,
`total_loss`): the reference's MultiBoxLoss (nets/retinaface_training.py
:165-303) and its DIoU variant (retinaface_training_DIOU.py:491-612) as
dense masked arithmetic over the batch, with:

  * landmark smooth-L1 over priors with conf_t > 0, box smooth-L1 (or
    1 - DIoU of the decoded box) over conf_t != 0;
  * hard-negative mining on the per-prior cross-entropy with positives
    zeroed: a double argsort ranks it, negatives are rank < min(7 *
    num_pos, P - 1); both argsorts are stable, as jnp.argsort is, so
    tied values mine the same priors;
  * cross-entropy over positives + mined negatives, normalized by
    N = max(num_pos, 1); landmarks by N1 = max(num_pos1, 1);
  * total = loc_weight * loss_l + loss_c + loss_landm.

Over a process mesh (`matching_mesh`, parallel/mesh.py) each rank matches
its own rows (K2 on the card, as the JAX package runs its Pallas matching
per shard under shard_map) and N, N1 are the sums over the mesh, so the
terms of the ranks add up to the terms of the global batch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from jabd_tpu_torch.ops import boxes as B
from jabd_tpu_torch.ops import matching
from jabd_tpu_torch.ops import matching_cuda
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.utils import tracing as T

MATCHING_IMPLS = ("auto", "cuda", "plain")


class Targets(NamedTuple):
    """Padded per-image ground truth (data/wider.py::batch_targets)."""

    boxes: torch.Tensor  # [B, G, 4] normalized corner form
    labels: torch.Tensor  # [B, G] 1.0 (landmarks) / -1.0 (no landmarks)
    landms: torch.Tensor  # [B, G, 10]
    valid: torch.Tensor  # [B, G] bool


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (beta 1): 0.5 x^2 if |x| < 1 else |x| - 0.5."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _match_front(matching_impl: str, device: torch.device):
    """The front half of the matching that `matching_impl` names."""
    if matching_impl == "plain":
        return matching.match_front_plain
    if matching_impl == "cuda" and device.type != "cuda":
        raise ValueError(f"matching_impl='cuda' needs CUDA tensors, got {device}")
    if matching_impl in ("auto", "cuda"):
        return matching_cuda.match_front
    raise ValueError(f"matching_impl {matching_impl!r} not in {MATCHING_IMPLS}")


def multibox_loss(
    predictions: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    priors: torch.Tensor,  # [P, 4] cxcywh
    targets: Targets,
    overlap_threshold: float = 0.35,
    neg_pos_ratio: int = 7,
    variances: Tuple[float, float] = (0.1, 0.2),
    box_loss: str = "smooth_l1",  # or 'diou'
    matching_impl: str = "auto",
    matching_mesh=None,
) -> Dict[str, torch.Tensor]:
    """dict(loss_l, loss_c, loss_landm), the three normalized terms.

    predictions: (loc [B, P, 4], conf logits [B, P, 2], landm [B, P, 10]),
    float32. Matching sees only targets and priors, so no gradient flows
    through it.

    `matching_mesh`: the process mesh the batch is sharded over; the
    predictions and targets are this rank's rows and the terms are its
    share of the global batch's (their sum over the ranks). A mesh of size
    1 is the plain path."""
    loc_data, conf_data, landm_data = predictions
    num_priors = conf_data.shape[1]

    with torch.no_grad(), T.span("jabd.train.match"):
        m = matching.match_batch(
            overlap_threshold,
            targets.boxes,
            priors,
            variances,
            targets.labels,
            targets.landms,
            targets.valid,
            front=_match_front(matching_impl, targets.boxes.device),
        )

    pos1 = m.conf_t > 0  # landmark positives [B, P]
    pos = m.conf_t != 0  # box positives      [B, P]

    landm_err = smooth_l1(landm_data - m.landm_t)
    loss_landm = torch.sum(torch.where(pos1[..., None], landm_err, 0.0))

    if box_loss == "smooth_l1":
        loc_err = smooth_l1(loc_data - m.loc_t)
        loss_l = torch.sum(torch.where(pos[..., None], loc_err, 0.0))
    elif box_loss == "diou":
        decoded = B.decode(loc_data, priors[None], variances)
        diou = B.elementwise_diou(decoded, m.box_t)
        loss_l = torch.sum(torch.where(pos, 1.0 - diou, 0.0))
    else:
        raise ValueError(f"unknown box_loss {box_loss!r}")

    # Per-prior cross-entropy lse(conf) - conf[target]: the mining rank
    # (positives zeroed) and the final CE term.
    gathered = torch.where(pos, conf_data[..., 1], conf_data[..., 0])
    ce = B.log_sum_exp(conf_data)[..., 0] - gathered
    with torch.no_grad():
        loss_rank = torch.where(pos, 0.0, ce)
        loss_idx = torch.argsort(-loss_rank, dim=-1, stable=True)
        idx_rank = torch.argsort(loss_idx, dim=-1, stable=True)
        num_pos = torch.sum(pos, dim=-1, keepdim=True)  # [B, 1]
        num_neg = torch.clamp(neg_pos_ratio * num_pos, max=num_priors - 1)
        sel = pos | (idx_rank < num_neg)
    loss_c = torch.sum(torch.where(sel, ce, 0.0))

    counts = M.all_reduce(torch.stack([torch.sum(num_pos), torch.sum(pos1)]).float(), matching_mesh)
    n = torch.clamp(counts[0], min=1.0)
    n1 = torch.clamp(counts[1], min=1.0)
    return {
        "loss_l": loss_l / n,
        "loss_c": loss_c / n,
        "loss_landm": loss_landm / n1,
    }


def total_loss(losses: Dict[str, torch.Tensor], loc_weight: float = 2.0) -> torch.Tensor:
    """loc_weight * loss_l + loss_c + loss_landm (train_mobilenetV3_ecagai.py:530)."""
    return loc_weight * losses["loss_l"] + losses["loss_c"] + losses["loss_landm"]
