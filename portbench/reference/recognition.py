"""Plain reference of the AdaFace training step, and the comparison that
judges the served steps by it.

The model is AdaFace's (Kim, Jain and Liu, "AdaFace: Quality Adaptive
Margin for Face Recognition", CVPR 2022; github.com/mk-minchul/AdaFace:
net.py `IR_101` / `BasicBlockIR`, head.py `AdaFace`, train_val.py), written
out from the numbers of a configuration file in float32 with plain torch
modules:

  input: conv3x3 (3 -> 64) -> BN -> PReLU;
  each unit (BasicBlockIR): BN -> conv3x3 -> BN -> PReLU -> conv3x3
  (stride) -> BN, plus the shortcut: a strided slice where the channels
  stay (MaxPool2d(1, stride)), else a strided 1x1 conv -> BN; the first
  unit of each stage has stride 2;
  output: BN2d -> Dropout -> flatten -> Linear -> affine-free BN1d; the
  embedding divided by its L2 norm, the norm returned beside it.

The head: cosine = embedding @ (kernel / its column norms), clipped to
[-1 + eps, 1 - eps]; the feature norms clipped to [0.001, 100] and
detached; in training the batch's norm mean and unbiased std folded into
`batch_mean` / `batch_std` at t_alpha; margin scaler = clip(h (norm -
batch_mean) / (batch_std + eps), -1, 1); on the target column the angle
moves by -m * scaler (theta clipped to [eps, pi - eps]) and the cosine by
-(m + m * scaler); logits = s * cosine. Cross-entropy over the classes.
SGD (torch's rule: decay added to the gradient, the momentum buffer
started at the first gradient, no dampening) with weight decay on every
parameter but the BatchNorms' and on the head's kernel (train_val.py's
split_parameters).

Departures from AdaFace's code, each the served package's stated rule:
- the BatchNorms' running variance takes the batch's biased variance
  (flax's BatchNorm; torch's takes the unbiased one), as in
  reference/model.py::BatchNorm2d; training normalizes identically;
- dropout draws its mask as the served package's train step does:
  torch.rand(shape) < 1 - p from a torch.Generator on the device seeded
  with (seed << 32) + step (`dropout_seed`), kept values scaled by
  1 / (1 - p); nn.Dropout draws from the global generator.

Submodule names follow the served package's state-dict layout
(`stage2_block0.shortcut_conv.weight`, `input_prelu.alpha`, `kernel`,
`batch_mean`), so one state dict loads into both. Convolutions are
reference/model.py's `Conv2d`, so `set_fp8` gives the float8 control.
This file imports torch only.

`train_gaps` gives, of each quantity, per leaf the gap of norms |served
norm - reference norm| over the larger of the reference leaf's norm and
the median leaf's, and of those the median (`<q>_median`) and the largest
(`<q>_worst`):

  grad_gap      the first gradient as SGD received it (gradient + decay x
                weight: the momentum buffer after one step);
  update_gap    each parameter's change after the steps;
  stats_gap     each BatchNorm running mean's and variance's change;
  momentum_gap  the momentum buffers after the steps;

and loss_gap, the relative gap of the first step's loss
(loss_gap_all_steps: the largest over the steps), and ema_gap, the larger
relative gap of the changes of the head's `batch_mean` and `batch_std`.
Leaves whose raw first gradient in the reference is under a thousandth of
the median leaf's are left out of the gradient, update and momentum gaps:
their gradient is nought to rounding, since a train-mode BatchNorm removes
any shift of its input (the Linear's bias before the affine-free
BatchNorm, and each unit's `bn2` and `shortcut_bn` shift, which reach the
loss only through the next unit's `bn0` or `output_bn`).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.model import BatchNorm2d, Conv2d, set_fp8

BN_EPS = 1e-5


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d keeping the batch's biased variance, as BatchNorm2d."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.float()
            mean, var = xf.mean(0), xf.var(0, unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class PReLU(nn.Module):
    """Per-channel PReLU with the served layout's parameter name `alpha`."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        a = self.alpha.to(x.dtype)[None, :, None, None]
        return torch.where(x >= 0, x, a * x)


def conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class BasicBlockIR(nn.Module):
    def __init__(self, cin: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        self.bn0 = BatchNorm2d(cin, eps=BN_EPS)
        self.conv1 = conv(cin, depth, 3)
        self.bn1 = BatchNorm2d(depth, eps=BN_EPS)
        self.prelu = PReLU(depth)
        self.conv2 = conv(depth, depth, 3, stride)
        self.bn2 = BatchNorm2d(depth, eps=BN_EPS)
        if cin != depth:
            self.shortcut_conv = conv(cin, depth, 1, stride)
            self.shortcut_bn = BatchNorm2d(depth, eps=BN_EPS)
        else:
            self.shortcut_conv = None

    def forward(self, x):
        res = self.bn2(self.conv2(self.prelu(self.bn1(self.conv1(self.bn0(x))))))
        if self.shortcut_conv is None:
            short = x[:, :, :: self.stride, :: self.stride]
        else:
            short = self.shortcut_bn(self.shortcut_conv(x))
        return res + short


class IRBackbone(nn.Module):
    """[B, 3, S, S] -> (unit-norm [B, D] embedding, [B, 1] norm). `model`:
    a configuration file's "model" entry (stages, embedding_size, dropout,
    image_size)."""

    def __init__(self, model: dict):
        super().__init__()
        self.dropout = model["dropout"]
        self.input_conv = conv(3, 64, 3)
        self.input_bn = BatchNorm2d(64, eps=BN_EPS)
        self.input_prelu = PReLU(64)
        cin, side = 64, model["image_size"]
        for si, (depth, units) in enumerate(model["stages"]):
            for bi in range(units):
                self.add_module(f"stage{si + 1}_block{bi}", BasicBlockIR(cin, depth, 2 if bi == 0 else 1))
                cin = depth
            side = -(-side // 2)
        self.output_bn = BatchNorm2d(cin, eps=BN_EPS)
        self.fc = nn.Linear(cin * side * side, model["embedding_size"])
        self.features_bn = BatchNorm1d(model["embedding_size"], eps=BN_EPS, affine=False)

    def forward(self, x, generator: torch.Generator = None):
        h = self.input_prelu(self.input_bn(self.input_conv(x)))
        for name, m in self.named_children():
            if name.startswith("stage"):
                h = m(h)
        h = self.output_bn(h)
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        h = self.features_bn(self.fc(h.flatten(1))).float()
        norm = torch.norm(h, 2, 1, True)
        return h / norm, norm


class AdaFace(nn.Module):
    """head.py's AdaFace, written out as AdaFace's code computes it: the
    margins over the whole [B, C] matrix through one-hot masks."""

    def __init__(self, classnum: int, embedding_size: int, m: float, h: float, s: float, t_alpha: float,
                 eps: float):
        super().__init__()
        self.m, self.h, self.s, self.t_alpha, self.eps = m, h, s, t_alpha, eps
        self.kernel = nn.Parameter(torch.zeros(embedding_size, classnum))
        self.register_buffer("batch_mean", torch.tensor(20.0))
        self.register_buffer("batch_std", torch.tensor(100.0))

    def forward(self, embeddings, norms, label):
        kernel_norm = self.kernel / torch.norm(self.kernel, 2, 0, True)
        cosine = torch.mm(embeddings, kernel_norm).clamp(-1 + self.eps, 1 - self.eps)
        safe_norms = torch.clip(norms, min=0.001, max=100).clone().detach()
        if self.training:
            with torch.no_grad():
                mean, std = safe_norms.mean(), safe_norms.std()
                self.batch_mean = mean * self.t_alpha + (1 - self.t_alpha) * self.batch_mean
                self.batch_std = std * self.t_alpha + (1 - self.t_alpha) * self.batch_std
        margin_scaler = torch.clip((safe_norms - self.batch_mean) / (self.batch_std + self.eps) * self.h, -1, 1)
        onehot = torch.zeros_like(cosine).scatter_(1, label.reshape(-1, 1), 1.0)
        theta_m = torch.clip(cosine.acos() + onehot * (self.m * margin_scaler * -1), min=self.eps,
                             max=math.pi - self.eps)
        cosine = theta_m.cos() - onehot * (self.m + self.m * margin_scaler)
        return cosine * self.s


def build(config: dict, fp8: bool = False):
    """(backbone, head) of a configuration file, float32, training mode."""
    m, hd = config["model"], config["head"]
    model = IRBackbone(m)
    head = AdaFace(hd["class_num"], m["embedding_size"], hd["m"], hd["h"], hd["s"], hd["t_alpha"], hd["eps"])
    if fp8:
        set_fp8(model)
    return model.train(), head.train()


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The served train step's dropout stream of step `step` (one chunk a
    step): a generator on `device` seeded with (seed << 32) + step."""
    return torch.Generator(device).manual_seed((seed << 32) + step)


class Trainer:
    """The reference's training: backbone, head and SGD's momentum
    buffers, one `step` a batch. `fp8`: the convolutions in float8 (the
    control); `bf16`: the backbone under bfloat16 autocast, the head and
    the loss in float32 (plain bfloat16 training, the yardstick)."""

    def __init__(self, config: dict, p0: Dict[str, torch.Tensor], dev, seed: int, fp8: bool = False,
                 bf16: bool = False):
        self.optim, self.dev, self.seed, self.bf16 = config["optimizer"], torch.device(dev), seed, bf16
        self.model, self.head = (x.to(self.dev) for x in build(config, fp8))
        load(self.model, self.head, p0)
        no_decay = {id(p) for mod in self.model.modules() if isinstance(mod, nn.modules.batchnorm._BatchNorm)
                    for p in mod.parameters()}
        self.params = named_parameters(self.model, self.head)
        self.decay = {n: 0.0 if id(p) in no_decay else self.optim["weight_decay"] for n, p in self.params.items()}
        self.buf: Dict[str, torch.Tensor] = {}
        self.t = 0
        self.raw1 = None

    def step(self, images, labels) -> torch.Tensor:
        """One step on NHWC `images` and [B] `labels`; returns the loss
        (a device scalar)."""
        for p in self.params.values():
            p.grad = None
        x = images.permute(0, 3, 1, 2)
        gen = dropout_generator(self.seed, self.t, x.device)
        with torch.autocast(self.dev.type, dtype=torch.bfloat16, enabled=self.bf16):
            emb, norm = self.model(x, generator=gen)
        loss = F.cross_entropy(self.head(emb.float(), norm.float(), labels.long()), labels.long())
        loss.backward()
        self.t += 1
        with torch.no_grad():
            if self.t == 1:
                self.raw1 = {n: p.grad.cpu() for n, p in self.params.items()}
            for n, p in self.params.items():
                d = p.grad + self.decay[n] * p
                if n in self.buf:
                    self.buf[n].mul_(self.optim["momentum"]).add_(d)
                else:
                    self.buf[n] = d.clone()
                p.sub_(self.optim["lr"] * self.buf[n])
        return loss.detach()


def named_parameters(model: nn.Module, head: nn.Module) -> Dict[str, nn.Parameter]:
    """Parameters by the combined state-dict name: `model.<name>` and
    `head.<name>`."""
    return {**{f"model.{n}": p for n, p in model.named_parameters()},
            **{f"head.{n}": p for n, p in head.named_parameters()}}


def state_dict(model: nn.Module, head: nn.Module) -> Dict[str, torch.Tensor]:
    """The combined state dict (`model.` and `head.` prefixes) on the host."""
    return {**{f"model.{k}": v.detach().cpu().clone() for k, v in model.state_dict().items()},
            **{f"head.{k}": v.detach().cpu().clone() for k, v in head.state_dict().items()}}


def load(model: nn.Module, head: nn.Module, p0: Dict[str, torch.Tensor]) -> None:
    """Loads a combined state dict (`state_dict`) into backbone and head."""
    for prefix, mod in (("model.", model), ("head.", head)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in p0.items() if k.startswith(prefix)}, strict=True)


def snapshot(model: nn.Module, head: nn.Module, buf: Dict[str, torch.Tensor]) -> dict:
    """What the comparison reads of a state after the steps, as host
    tensors by combined name: the parameters, the BatchNorms' running
    statistics, the momentum buffers and the head's norm EMA."""
    sd = state_dict(model, head)
    return {"params": {n: p.detach().cpu().clone() for n, p in named_parameters(model, head).items()},
            "stats": {n: v for n, v in sd.items() if "running_" in n},
            "momentum": {n: x.detach().cpu().clone() for n, x in buf.items()},
            "ema": {n: sd[f"head.{n}"] for n in ("batch_mean", "batch_std")}}


def reference_steps(config: dict, p0: Dict[str, torch.Tensor], batches: Sequence, dev, seed: int,
                    fp8: bool = False, bf16: bool = False) -> dict:
    """len(batches) reference steps from the combined state dict p0: the
    losses, the first raw gradient, the first gradient as SGD received it
    and the state after the last step (`snapshot`)."""
    trainer = Trainer(config, p0, dev, seed, fp8=fp8, bf16=bf16)
    losses: List[float] = []
    for images, labels in batches:
        losses.append(float(trainer.step(images, labels)))
        if trainer.t == 1:
            grad1 = {n: x.cpu().clone() for n, x in trainer.buf.items()}
    return {"losses": losses, "raw1": trainer.raw1, "grad1": grad1,
            "after": snapshot(trainer.model, trainer.head, trainer.buf)}


def train_gaps(losses: Sequence[float], grad1: dict, after: dict, p0: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the module docstring, of the served side's losses,
    first gradient and state after the steps (`snapshot`), started from
    the combined state dict p0."""
    return _gaps(losses, grad1, after, p0, ref)[0]


def train_diagnostics(losses, grad1, after, p0, ref) -> dict:
    """Beside the numbers: how many leaves count, which were left out, and
    where each gap's worst leaf lies."""
    return _gaps(losses, grad1, after, p0, ref)[1]


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
        "momentum_gap": per_leaf({n: after["momentum"][n] for n in leaves}, {n: r["momentum"][n] for n in leaves}),
    }
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    numbers = {"loss_gap": rel[0], "loss_gap_all_steps": max(rel)}
    ema = {n: (float(after["ema"][n]) - float(p0[f"head.{n}"]), float(r["ema"][n]) - float(p0[f"head.{n}"]))
           for n in ("batch_mean", "batch_std")}
    numbers["ema_gap"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in ema.values())
    worst = {"leaves": len(leaves), "left_out": sorted(set(norm) - set(leaves)),
             "ema_change": {n: list(v) for n, v in ema.items()}}
    for key, per in gaps.items():
        numbers[f"{key}_median"] = statistics.median(per.values())
        numbers[f"{key}_worst"] = max(per.values())
        worst[f"{key}_worst_at"] = str(max(per, key=per.get))
    return numbers, worst
