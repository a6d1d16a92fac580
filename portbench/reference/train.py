"""Plain reference of the training step, and the comparison that judges
the served steps by it.

One step (the reference repository's train_mobilenetV3_ecagai.py with
MultiBoxLoss(2, 0.35, 7) and Adam, as the served package documents it):
the train-mode float32 forward; dense matching (each prior's best GT,
each GT's best prior forced onto it, the last GT winning a shared prior,
labels below the overlap threshold set to background); smooth-L1 box and
landmark terms; cross-entropy over the positives and the 7 x positives
hardest negatives (ranked by a stable double argsort, positives zeroed),
normalized by the positive counts; total = loc_weight * box + conf +
landmark; backward; Adam with L2 weight decay added to the gradient
(betas 0.9 / 0.999, eps 1e-8). Written out here with torch operations.
The BatchNorms normalize by the batch statistics and keep running
statistics with momentum 0.1 and the biased batch variance, as the served
package states (reference/model.py::BatchNorm2d).

`train_gaps` gives, of each quantity, per leaf the gap of norms
|served norm - reference norm| over the larger of the reference leaf's
norm and the median leaf's, and of those the median (`<q>_median`) and
the largest (`<q>_worst`):

  grad_gap    the first gradient as Adam received it (gradient + decay x
              weight), from the first moment after one step;
  update_gap  each parameter's change after the steps;
  stats_gap   each BatchNorm running mean's and variance's change after
              the steps;
  adam_gap    Adam's first and second moments after the steps;

and loss_gap, the relative gap of the first step's loss
(loss_gap_all_steps: the largest over the steps). A cell's limits file
names the ones it compares.

Leaves whose raw first gradient in the reference is under a thousandth of
the median leaf's are left out of the gradient, update and Adam gaps:
their gradient is nought to rounding (a bias before a BatchNorm), and
Adam moves them by round-off.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from portbench.reference.model import RetinaFace, set_fp8

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def point_form(p):
    return torch.cat([p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2], 1)


def iou_matrix(truths, corners):
    """[B, G, 4] x [P, 4] corner boxes -> [B, G, P]."""
    t = truths[:, :, None, :]
    p = corners[None, None]
    wh = (torch.minimum(t[..., 2:], p[..., 2:]) - torch.maximum(t[..., :2], p[..., :2])).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_t = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    area_p = (p[..., 2] - p[..., 0]) * (p[..., 3] - p[..., 1])
    return inter / (area_t + area_p - inter)


def match(boxes, labels, landms, valid, priors, threshold, variances):
    """Targets per prior: (loc_t [B,P,4], conf_t [B,P], landm_t [B,P,10])."""
    v0, v1 = variances
    bsz, g = valid.shape
    ov = torch.where(valid[..., None], iou_matrix(boxes, point_form(priors)), -1.0)
    best_prior = ov.argmax(2)  # [B, G]
    best_ov = ov.amax(1)  # [B, P]
    best_idx = ov.argmax(1)  # [B, P]
    for j in range(g):
        rows = torch.nonzero(valid[:, j]).flatten()
        best_idx[rows, best_prior[rows, j]] = j
        best_ov[rows, best_prior[rows, j]] = 2.0
    pick = best_idx[..., None]
    matched = torch.gather(boxes, 1, pick.expand(-1, -1, 4))
    lms = torch.gather(landms, 1, pick.expand(-1, -1, 10))
    conf = torch.gather(labels, 1, best_idx)
    conf = torch.where(best_ov < threshold, torch.zeros_like(conf), conf)
    g_cxcy = ((matched[..., :2] + matched[..., 2:]) / 2 - priors[:, :2]) / (v0 * priors[:, 2:])
    g_wh = torch.log(((matched[..., 2:] - matched[..., :2]) / priors[:, 2:]).clamp(min=1e-12)) / v1
    loc = torch.cat([g_cxcy, g_wh], -1)
    lm = ((lms.view(bsz, -1, 5, 2) - priors[:, None, :2]) / (v0 * priors[:, None, 2:])).view(bsz, -1, 10)
    fg = (conf != 0)[..., None]
    return torch.where(fg, loc, 0.0), conf, torch.where(fg, lm, 0.0)


def smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(out, targets, priors, recipe, variances):
    loc, conf, landm = out
    loc_t, conf_t, landm_t = match(*targets, priors, recipe["overlap_threshold"], variances)
    pos1, pos = conf_t > 0, conf_t != 0
    loss_landm = torch.where(pos1[..., None], smooth_l1(landm - landm_t), 0.0).sum()
    loss_l = torch.where(pos[..., None], smooth_l1(loc - loc_t), 0.0).sum()
    ce = torch.logsumexp(conf, -1) - torch.where(pos, conf[..., 1], conf[..., 0])
    with torch.no_grad():
        rank = torch.argsort(torch.argsort(-torch.where(pos, 0.0, ce), dim=-1, stable=True), dim=-1, stable=True)
        num_pos = pos.sum(-1, keepdim=True)
        sel = pos | (rank < (recipe["neg_pos_ratio"] * num_pos).clamp(max=conf.shape[1] - 1))
    loss_c = torch.where(sel, ce, 0.0).sum()
    n = pos.sum().clamp(min=1).float()
    n1 = pos1.sum().clamp(min=1).float()
    return recipe["loc_weight"] * loss_l / n + loss_c / n + loss_landm / n1


class Trainer:
    """The reference's training: a train-mode model and Adam's moments,
    one `step` a batch. `fp8`: the convolutions in float8 (the control);
    `bf16`: the forward under bfloat16 autocast (plain bfloat16 training,
    the yardstick)."""

    def __init__(self, config: dict, p0: Dict[str, torch.Tensor], dev, fp8: bool = False, bf16: bool = False):
        self.recipe, self.dev, self.bf16 = config["train"], torch.device(dev), bf16
        self.variances = config["model"]["anchors"]["variance"]
        self.model = RetinaFace(config["model"], "train").to(self.dev)
        self.model.load_state_dict(p0)
        self.model.train()
        if fp8:
            set_fp8(self.model)
        self.params = dict(self.model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0
        self.raw1 = None

    def step(self, images, targets, priors) -> torch.Tensor:
        """One step on NHWC `images`; returns the loss (a device scalar)."""
        self.t += 1
        for p in self.params.values():
            p.grad = None
        with torch.autocast(self.dev.type, dtype=torch.bfloat16, enabled=self.bf16):
            out = self.model(images.permute(0, 3, 1, 2))
        loss = multibox_loss(out, targets, priors, self.recipe, self.variances)
        loss.backward()
        with torch.no_grad():
            if self.t == 1:
                self.raw1 = {n: p.grad.cpu() for n, p in self.params.items()}
            for n, p in self.params.items():
                g = p.grad + self.recipe["weight_decay"] * p
                self.m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
                self.v[n].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (self.v[n] / (1 - BETA2 ** self.t)).sqrt() + EPS
                p.sub_(self.recipe["lr"] * (self.m[n] / (1 - BETA1 ** self.t)) / denom)
        return loss.detach()


def first_gradient(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradient as Adam received it in its first step (decay added),
    worked out from the first moment after that step."""
    return {n: (x / (1.0 - BETA1)).cpu() for n, x in m.items()}


def snapshot(model: torch.nn.Module, m: dict, v: dict) -> dict:
    """What the comparison reads of a state after the steps, as host
    tensors by name: the parameters, the BatchNorms' running statistics
    and Adam's two moments."""
    return {"params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            "stats": {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running_" in n},
            "m": {n: x.detach().cpu().clone() for n, x in m.items()},
            "v": {n: x.detach().cpu().clone() for n, x in v.items()}}


def reference_steps(config: dict, p0: Dict[str, torch.Tensor], batches: Sequence, priors: torch.Tensor,
                    dev, fp8: bool = False, bf16: bool = False) -> dict:
    """len(batches) reference steps from the state dict p0: the losses,
    the first raw gradient and the first gradient as Adam received it,
    and the state after the last step (`snapshot`)."""
    trainer = Trainer(config, p0, dev, fp8=fp8, bf16=bf16)
    losses: List[float] = []
    for images, targets in batches:
        losses.append(float(trainer.step(images, targets, priors)))
        if trainer.t == 1:
            grad1 = first_gradient(trainer.m)
    return {"losses": losses, "raw1": trainer.raw1, "grad1": grad1,
            "after": snapshot(trainer.model, trainer.m, trainer.v)}


def train_gaps(losses: Sequence[float], grad1: dict, after: dict, p0: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the module docstring, of the served side's losses,
    first gradient and state after the steps (`snapshot`), started from
    the state dict p0."""
    return _gaps(losses, grad1, after, p0, ref)[0]


def _gaps(losses, grad1, after, p0, ref):
    norm = {n: float(g.double().norm()) for n, g in ref["raw1"].items()}
    floor = 1e-3 * statistics.median(norm.values())
    leaves = [n for n in norm if norm[n] >= floor]

    def per_leaf(got: dict, want: dict) -> Dict[str, float]:
        g = {n: float(got[n].double().norm()) for n in want}
        w = {n: float(want[n].double().norm()) for n in want}
        med = statistics.median(w.values())
        return {n: abs(g[n] - w[n]) / max(w[n], med) for n in want}

    def change(state: dict, key: str, names) -> dict:
        return {n: state[key][n].double() - p0[n].double() for n in names}

    r = ref["after"]
    stats = sorted(r["stats"])
    gaps = {
        "grad_gap": per_leaf(grad1, {n: ref["grad1"][n] for n in leaves}),
        "update_gap": per_leaf(change(after, "params", leaves), change(r, "params", leaves)),
        "stats_gap": per_leaf(change(after, "stats", stats), change(r, "stats", stats)),
        "adam_gap": {**{("m", n): x for n, x in per_leaf({n: after["m"][n] for n in leaves},
                                                       {n: r["m"][n] for n in leaves}).items()},
                     **{("v", n): x for n, x in per_leaf({n: after["v"][n] for n in leaves},
                                                       {n: r["v"][n] for n in leaves}).items()}},
    }
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    numbers = {"loss_gap": rel[0], "loss_gap_all_steps": max(rel)}
    worst = {"leaves": len(leaves), "left_out": sorted(set(norm) - set(leaves))}
    for key, per in gaps.items():
        numbers[f"{key}_median"] = statistics.median(per.values())
        numbers[f"{key}_worst"] = max(per.values())
        worst[f"{key}_worst_at"] = str(max(per, key=per.get))
    return numbers, worst


def yardstick_ratios(numbers: Dict[str, float], plain: Dict[str, float]) -> Dict[str, float]:
    """Each number over plain bfloat16 training's (`reference_steps(bf16=
    True)` held to the float32 reference the same way): `<name>_vs_bf16`.
    How far bfloat16 moves a seeded detector's gradients differs from seed
    to seed; in its units the served step reads alike on every seed."""
    return {f"{k}_vs_bf16": v / max(plain[k], 1e-12) for k, v in numbers.items()}


def train_diagnostics(losses, grad1, after, p0, ref) -> dict:
    """Beside the numbers: how many leaves count, which were left out, and
    where each gap's worst leaf lies."""
    return _gaps(losses, grad1, after, p0, ref)[1]
