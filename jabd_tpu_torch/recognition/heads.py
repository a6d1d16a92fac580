"""Margin-softmax heads: AdaFace, ArcFace, CosFace.

Port of `jabd_tpu/recognition/heads.py`. Each head maps (unit-norm [B, D]
embeddings, [B, 1] feature norms, [B] labels) to [B, width] scaled margin
logits. AdaFace adapts its margin to the feature norm, the quality proxy:
with z = clip((||f|| - mu) / (sigma + eps) * h, -1, 1),

  target logit = s * (cos(theta - m * z) - (m * z + m)),

mu and sigma tracking the batch's norm statistics (EMA, momentum
t_alpha = 0.01) in training mode. ArcFace adds m to the target angle,
CosFace subtracts m from the target cosine.

`kernel` is an [embedding_size, width] float32 parameter (not a Linear:
the flax path `head.kernel` keeps its layout), drawn N(0, 0.01^2) from a
torch.Generator; AdaFace's `batch_mean` (20.0) and `batch_std` (100.0) are
0-d buffers. `pad_to` > 1 rounds the width up to a multiple of it and
gives the padding columns a logit of -3e4, so they take no softmax mass
and no gradient.

The heads compute in float32 whatever the caller's autocast says, and the
cosine product runs at full float32 precision in both passes, TF32 off
(`_F32MatMul`): ~3e-3 of cosine error would become +-0.2 on s = 64
logits that feed arccos. The margin touches the target column only: one
arccos / cos per row, not over the [B, C] matrix (off the target column
cos(arccos x) is the identity).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from jabd_tpu_torch import resolve_device


def _kernel_width(classnum: int, pad_to: int) -> int:
    """The classifier's width: `classnum` rounded up to a multiple of
    `pad_to` when pad_to > 1."""
    if pad_to <= 1:
        return classnum
    return -(-classnum // pad_to) * pad_to


class _F32MatMul(torch.autograd.Function):
    """a @ b with TF32 off on the card in the forward and in both backward
    products (the JAX package's Precision.HIGHEST)."""

    @staticmethod
    def _mm(a, b):
        if a.device.type != "cuda":
            return a @ b
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _F32MatMul._mm(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = _F32MatMul._mm(grad, b.t()) if ctx.needs_input_grad[0] else None
        gb = _F32MatMul._mm(a.t(), grad) if ctx.needs_input_grad[1] else None
        return ga, gb


class _MarginHead(nn.Module):
    """What the three heads share: the kernel, the clipped cosine and the
    masking of padding columns."""

    def __init__(self, classnum: int, embedding_size: int, m: float, s: float, eps: float, pad_to: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.classnum, self.embedding_size = classnum, embedding_size
        self.m, self.s, self.eps, self.pad_to = m, s, eps, pad_to
        width = _kernel_width(classnum, pad_to)
        self.kernel = nn.Parameter(torch.randn(embedding_size, width, generator=generator) * 0.01)

    def _cosine(self, embeddings):
        kernel = self.kernel.float()
        kernel = kernel / torch.linalg.vector_norm(kernel, dim=0, keepdim=True).clamp_min(1e-12)
        return _F32MatMul.apply(embeddings.float(), kernel).clamp(-1 + self.eps, 1 - self.eps)

    def _scaled(self, logits):
        """s * logits, padding columns at -3e4."""
        logits = logits * self.s
        if logits.shape[-1] == self.classnum:
            return logits
        pad = torch.arange(logits.shape[-1], device=logits.device) >= self.classnum
        return logits.masked_fill(pad, -3e4)

    def forward(self, embeddings, norms, labels):
        with torch.autocast(embeddings.device.type, enabled=False):
            cosine = self._cosine(embeddings)
            idx = labels.long()[:, None]
            return self._scaled(self._margin(cosine, idx, norms))

    def _margin(self, cosine, idx, norms):
        """cosine + delta at each row's target column, without the [B, C]
        one-hot; `_delta(target cosine [B, 1], norms)` is the head's."""
        return cosine.scatter_add(1, idx, self._delta(cosine.gather(1, idx), norms))


class AdaFaceHead(_MarginHead):
    def __init__(self, classnum: int, embedding_size: int = 512, m: float = 0.4, h: float = 0.333,
                 s: float = 64.0, t_alpha: float = 0.01, eps: float = 1e-3, pad_to: int = 0,
                 generator: torch.Generator = None):
        super().__init__(classnum, embedding_size, m, s, eps, pad_to, generator)
        self.h, self.t_alpha = h, t_alpha
        self.register_buffer("batch_mean", torch.tensor(20.0))
        self.register_buffer("batch_std", torch.tensor(100.0))

    def _delta(self, tgt, norms):
        # The norms are a quality observation, not a gradient path (the
        # official AdaFace's safe_norms.clone().detach()).
        safe_norms = norms.float().clamp(0.001, 100.0).detach()
        if self.training:
            mean, std = safe_norms.mean(), safe_norms.std()  # torch.std: unbiased
            self.batch_mean = self.t_alpha * mean + (1 - self.t_alpha) * self.batch_mean
            self.batch_std = self.t_alpha * std + (1 - self.t_alpha) * self.batch_std
        # The scaler reads the statistics after this step's update.
        scaler = (safe_norms[:, 0] - self.batch_mean) / (self.batch_std + self.eps)
        scaler = (scaler * self.h).clamp(-1.0, 1.0)[:, None]
        theta_m = (torch.arccos(tgt) + -self.m * scaler).clamp(self.eps, math.pi - self.eps)
        tgt_new = torch.cos(theta_m) - (self.m * scaler + self.m)
        return tgt_new - tgt


class ArcFaceHead(_MarginHead):
    def __init__(self, classnum: int, embedding_size: int = 512, m: float = 0.5, s: float = 64.0,
                 eps: float = 1e-3, pad_to: int = 0, generator: torch.Generator = None):
        super().__init__(classnum, embedding_size, m, s, eps, pad_to, generator)

    def _delta(self, tgt, norms):
        theta_m = (torch.arccos(tgt) + self.m).clamp(self.eps, math.pi - self.eps)
        return torch.cos(theta_m) - tgt


class CosFaceHead(_MarginHead):
    def __init__(self, classnum: int, embedding_size: int = 512, m: float = 0.4, s: float = 64.0,
                 eps: float = 1e-3, pad_to: int = 0, generator: torch.Generator = None):
        super().__init__(classnum, embedding_size, m, s, eps, pad_to, generator)

    def _delta(self, tgt, norms):
        return torch.full(tgt.shape, -self.m, device=tgt.device)


def build_head(
    head_type: str = "adaface",
    embedding_size: int = 512,
    class_num: int = 70722,
    m: float = 0.4,
    h: float = 0.333,
    t_alpha: float = 0.01,
    s: float = 64.0,
    pad_to: int = 0,
    seed: int = 0,
    device=None,
) -> nn.Module:
    """The head `head_type` ("adaface", "arcface" or "cosface", any case)
    on `device` (the card unless given), its kernel drawn on the CPU from
    a torch.Generator seeded with `seed`, so that every device gets the
    same weights. Raises ValueError for another type."""
    head_type = head_type.lower()
    g = torch.Generator().manual_seed(seed)
    if head_type == "adaface":
        head = AdaFaceHead(class_num, embedding_size, m=m, h=h, s=s, t_alpha=t_alpha, pad_to=pad_to, generator=g)
    elif head_type == "arcface":
        head = ArcFaceHead(class_num, embedding_size, m=m, s=s, pad_to=pad_to, generator=g)
    elif head_type == "cosface":
        head = CosFaceHead(class_num, embedding_size, m=m, s=s, pad_to=pad_to, generator=g)
    else:
        raise ValueError(f"unknown head type {head_type!r}")
    return head.to(resolve_device(device))
