"""Shared building blocks of the detector, NCHW `nn.Module`s.

Port of `jabd_tpu/models/layers.py`: activations, `ConvBN`, `ECA` (avg
and stdv statistics), `SEModule`, `PSP` + `NLM`, `SSH`, `PixelShuffleUp`,
the `FPN` (cascade and the two 4-level wirings) and `PredictionHead`.
Submodule names mirror the flax names, so a flax parameter path is a
state-dict key with '/' read as '.' (`utils/convert.py`).

Each module that holds a BatchNorm has `fold_()`, which merges the
BatchNorm into the conv before it (models/fold.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from jabd_tpu_torch.ops import resize as R
from jabd_tpu_torch.parallel import mesh as M

BN_EPS = 1e-5


# ---------------------------------------------------------------------------
# Activations, written out as the JAX package writes them
# ---------------------------------------------------------------------------


def hswish(x):
    """x * relu6(x + 3) / 6."""
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x):
    """relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


ACTIVATIONS = {
    "relu": F.relu,
    "hswish": hswish,
    "hsigmoid": hsigmoid,
    "none": lambda x: x,
}


def segment(fn, x, remat: bool):
    """fn(x), or with remat under a non-reentrant checkpoint: backward
    recomputes the segment's activations instead of keeping them, so only
    its input stays alive between the forward and the backward."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def eca_kernel_size(channels: int, b: int = 1, gamma: int = 2) -> int:
    """Adaptive ECA kernel: k = |log2(C)+b|/gamma rounded up to odd."""
    k = int(abs((math.log(channels, 2) + b) / gamma))
    return k if k % 2 else k + 1


def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """A conv with bias computing conv followed by eval-mode `bn`:
    s = scale / sqrt(var + eps), weight * s, bias (b0 - mean) * s + beta."""
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    bias0 = conv.bias if conv.bias is not None else 0.0
    out = nn.Conv2d(
        conv.in_channels,
        conv.out_channels,
        conv.kernel_size,
        stride=conv.stride,
        padding=conv.padding,
        groups=conv.groups,
        bias=True,
        device=conv.weight.device,
        dtype=conv.weight.dtype,
    )
    with torch.no_grad():
        out.weight.copy_(conv.weight * s[:, None, None, None])
        out.bias.copy_((bias0 - bn.running_mean) * s + bn.bias)
    return out


# ---------------------------------------------------------------------------
# Conv + BN
# ---------------------------------------------------------------------------


class _FlaxRunningVar:
    """Training-mode running variance as flax's BatchNorm keeps it.

    Both normalize a training batch with its biased variance and keep
    running = (1 - m) * running + m * batch (flax momentum 0.9 is torch
    momentum 0.1). torch folds the UNBIASED batch variance (x n / (n - 1),
    n = numel / C) into running_var, flax the biased one. After torch's own
    update the batch term m * var_u is running_var' - (1 - m) * running_var,
    and m * var_b is that times (n - 1) / n; so the correction costs a few
    C-sized ops and no pass over the activations. Only training mode
    differs from torch's BatchNorm."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        old_var = self.running_var.clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            batch_term = self.running_var - (1.0 - self.momentum) * old_var
            # A new tensor, not an in-place update: autograd saved the
            # buffer torch just updated with the batch-norm node.
            self.running_var = self.running_var - batch_term / n
        return y


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's running variance (`_FlaxRunningVar`)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """nn.BatchNorm1d with flax's running variance (`_FlaxRunningVar`);
    affine-free when `affine` is False (the IR backbones' features_bn)."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1, affine=affine)


class _SyncFlaxBatchNorm:
    """Training-mode BatchNorm over the global batch of a process mesh.

    Per channel, the sum of x and the count, then the sum of (x - mean)^2,
    are all-reduced over the mesh with their gradient
    (`parallel.mesh.all_reduce_sum`): the batch is normalized with the
    global mean and BIASED variance, and the running statistics fold those
    with flax's rule (running_var takes the biased variance, so no n / (n -
    1) and no local n), as flax's BatchNorm does when GSPMD shards the batch
    of the JAX package's step. Statistics are float32 at least, whatever
    autocast says. On a mesh of size 1, and in eval mode, the module is the plain
    BatchNorm it replaced."""

    mesh = None

    def forward(self, x):
        if not (self.training and self.mesh is not None and self.mesh.size > 1):
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=x.device)
        s1 = M.all_reduce_sum(torch.cat([xf.sum(dims), count]), self.mesh)
        n = s1[c]
        mean = s1[:c] / n
        var = M.all_reduce_sum(((xf - mean.view(shape)) ** 2).sum(dims), self.mesh) / n
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean = (1.0 - m) * self.running_mean + m * mean.detach()
                self.running_var = (1.0 - m) * self.running_var + m * var.detach()
                self.num_batches_tracked = self.num_batches_tracked + 1
        return y.to(x.dtype)


class SyncBatchNorm2d(_SyncFlaxBatchNorm, BatchNorm2d):
    """BatchNorm2d whose training statistics span the mesh."""


class SyncBatchNorm1d(_SyncFlaxBatchNorm, BatchNorm1d):
    """BatchNorm1d whose training statistics span the mesh."""


def convert_sync_batchnorm(model: nn.Module, mesh) -> nn.Module:
    """Make every BatchNorm2d / BatchNorm1d of `model` synchronized over
    `mesh`, in place (the class is swapped, so the state dict keeps its
    names and values). Idempotent; returns the model."""
    for m in model.modules():
        if type(m) is BatchNorm2d:
            m.__class__ = SyncBatchNorm2d
        elif type(m) is BatchNorm1d:
            m.__class__ = SyncBatchNorm1d
        if isinstance(m, _SyncFlaxBatchNorm):
            m.mesh = mesh
    return model


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation.

    act: 'relu' | 'hswish' | 'none', or a float LeakyReLU slope (slope 0
    is ReLU, as the reference's LeakyReLU(0) is). After `fold_()` the conv
    carries the BatchNorm as a bias; int8 quantization then replaces it by
    a `models/quantize.QConv` (the JAX ConvBN's `qconv` branch), and
    `quantize.calibrate` taps the input with a forward pre-hook (its
    `quant_calib` sow).
    """

    def __init__(
        self,
        cin: int,
        cout: int,
        kernel: int = 3,
        stride: int = 1,
        act: Union[str, float] = 0.0,
        groups: int = 1,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, stride=stride, padding=kernel // 2,
            groups=groups, bias=False,
        )
        self.bn: Optional[nn.BatchNorm2d] = BatchNorm2d(cout)
        self.act = act

    def fold_(self) -> None:
        if self.bn is not None:
            self.conv = fold_conv_bn(self.conv, self.bn)
            self.bn = None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if isinstance(self.act, str):
            return ACTIVATIONS[self.act](x)
        return F.leaky_relu(x, negative_slope=float(self.act))


# ---------------------------------------------------------------------------
# Channel attention
# ---------------------------------------------------------------------------


def _spatial_stdv(x):
    """Per-channel spatial standard deviation: population variance (divide
    by H*W), square root without eps. [B, C, H, W] -> [B, C]."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    return torch.sqrt(((x - mean) ** 2).mean(dim=(2, 3)))


class ECA(nn.Module):
    """Efficient channel attention: a k-tap 1-D conv across channels
    (padding k//2, no bias) over the spatial mean ('avg') or spatial
    standard deviation ('stdv'), gated by sigmoid or hsigmoid."""

    def __init__(self, channels: int, statistic: str = "avg", gate: str = "hsigmoid"):
        super().__init__()
        k = eca_kernel_size(channels)
        self.conv1d = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.statistic = statistic
        self.gate = torch.sigmoid if gate == "sigmoid" else hsigmoid

    def forward(self, x):
        stat = _spatial_stdv(x) if self.statistic == "stdv" else x.mean(dim=(2, 3))
        y = self.conv1d(stat[:, None, :])[:, 0]  # [B, C]
        return x * self.gate(y)[:, :, None, None]


class SEModule(nn.Module):
    """Squeeze-excite: GAP -> 1x1 (max(C//4, 8)) + BN + ReLU -> 1x1 ->
    hsigmoid; both convs bias-free."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        e = max(channels // reduction, 8)
        self.fc1 = nn.Conv2d(channels, e, 1, bias=False)
        self.bn: Optional[nn.BatchNorm2d] = BatchNorm2d(e)
        self.fc2 = nn.Conv2d(e, channels, 1, bias=False)

    def fold_(self) -> None:
        if self.bn is not None:
            self.fc1 = fold_conv_bn(self.fc1, self.bn)
            self.bn = None

    def forward(self, x):
        y = self.fc1(x.mean(dim=(2, 3), keepdim=True))
        if self.bn is not None:
            y = self.bn(y)
        y = self.fc2(F.relu(y))
        return x * hsigmoid(y)


# ---------------------------------------------------------------------------
# Non-local module with PSP-pooled keys/values (CSAF)
# ---------------------------------------------------------------------------


def psp(x, sizes: Sequence[int]):
    """Pyramid pooling of NCHW x to S = sum(s^2) positions, each level
    flattened row-major: [B, S, C]."""
    return torch.cat(
        [R.adaptive_avg_pool(x, (s, s)).flatten(2) for s in sizes], dim=2
    ).transpose(1, 2)


class NLM(nn.Module):
    """Non-local attention with PSP-pooled keys and values, scale 1,
    softmax in float32; the output projection W starts at zero, so the
    module is the identity at init. Returns W(context) + x."""

    def __init__(self, channels: int, ch: int = 40, psp_sizes: Tuple[int, ...] = (1, 3, 6, 8)):
        super().__init__()
        self.ch = ch
        self.psp_sizes = tuple(psp_sizes)
        self.f_query = nn.Conv2d(channels, ch, 1)
        self.f_key = nn.Conv2d(channels, ch, 1)
        self.f_value = nn.Conv2d(channels, ch, 1)
        self.W = nn.Conv2d(ch, channels, 1)
        nn.init.zeros_(self.W.weight)
        nn.init.zeros_(self.W.bias)

    def forward(self, x):
        k = psp(self.f_key(x), self.psp_sizes)  # [B, S, ch]
        v = psp(self.f_value(x), self.psp_sizes)  # [B, S, ch]
        return self.attend(x, k, v)

    def attend(self, x, k, v):
        """W(softmax(q k^T) v) + x for the queries of x [B, C, H, W] and
        the pooled keys and values k, v [B, S, ch]."""
        b, _, h, w = x.shape
        q = self.f_query(x).flatten(2).transpose(1, 2)  # [B, HW, ch]
        sim = torch.bmm(q, k.transpose(1, 2))  # [B, HW, S]
        attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
        ctx = torch.bmm(attn, v).transpose(1, 2).reshape(b, self.ch, h, w)
        return self.W(ctx) + x


# ---------------------------------------------------------------------------
# SSH context module
# ---------------------------------------------------------------------------


class SSH(nn.Module):
    """3x3 + 5x5 (two 3x3) + 7x7 (three 3x3) branches with out/2, out/4,
    out/4 channels, concatenated, then ReLU; LeakyReLU 0.1 inside the
    branches iff out <= 64, else ReLU."""

    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        if out_channels % 4:
            raise ValueError(f"SSH needs out_channels % 4 == 0, got {out_channels}")
        leaky = 0.1 if out_channels <= 64 else 0.0
        c2, c4 = out_channels // 2, out_channels // 4
        self.conv3x3 = ConvBN(cin, c2, 3, act="none")
        self.conv5x5_1 = ConvBN(cin, c4, 3, act=leaky)
        self.conv5x5_2 = ConvBN(c4, c4, 3, act="none")
        self.conv7x7_2 = ConvBN(c4, c4, 3, act=leaky)
        self.conv7x7_3 = ConvBN(c4, c4, 3, act="none")

    def forward(self, x):
        c5_1 = self.conv5x5_1(x)
        out = torch.cat(
            [
                self.conv3x3(x),
                self.conv5x5_2(c5_1),
                self.conv7x7_3(self.conv7x7_2(c5_1)),
            ],
            dim=1,
        )
        return F.relu(out)


# ---------------------------------------------------------------------------
# FPN
# ---------------------------------------------------------------------------


class PixelShuffleUp(nn.Module):
    """Learned x`factor` upsample: a 3x3 conv with bias to C * r^2
    channels, then depth-to-space in nn.PixelShuffle's channel order,
    out[c, h*r + i, w*r + j] = in[c*r*r + i*r + j, h, w], which is also
    the JAX package's."""

    def __init__(self, channels: int, factor: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels * factor * factor, 3, padding=1)
        self.shuffle = nn.PixelShuffle(factor)

    def forward(self, x):
        return self.shuffle(self.conv(x))


class FPN(nn.Module):
    """Top-down pyramid. Laterals are 1x1 ConvBNs; the upsample of a level
    to the size of the one above is `upsample` ('nearest', 'bilinear',
    'bicubic' with align_corners=True, or 'pixelshuffle': one learned
    PixelShuffleUp shared by all levels, its x2 output cropped to the
    target grid), followed by an NLM shared by all levels when given.

    variant 'cascade': each level fuses the MERGED map of the level below
    through its own 3x3 merge conv (`merge1`..). The 4-level variants
    share ONE merge conv (`merge_shared`) and keep the reference's order,
    2 -> 1, then 4 -> 3, then 3 -> 2; outputs [o1, o2, o3, l4]:
      'raw152':   o2 fuses the merged level 3 (o3);
      'raw152_5': o2 fuses the raw level-3 lateral.
    """

    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: int,
        upsample: str = "nearest",
        nlm_ch: Optional[int] = None,
        nlm_psp: Tuple[int, ...] = (1, 3, 6, 8),
        variant: str = "cascade",
    ):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0.0
        n = len(in_channels)
        self.upsample = upsample
        self.variant = variant
        for i, cin in enumerate(in_channels):
            self.add_module(f"output{i + 1}", ConvBN(cin, out_channels, 1, act=leaky))
        if variant == "cascade":
            for i in range(n - 1):
                self.add_module(
                    f"merge{i + 1}", ConvBN(out_channels, out_channels, 3, act=leaky)
                )
        elif variant in ("raw152", "raw152_5"):
            if n != 4:
                raise ValueError(f"{variant} is the 4-level reference wiring, got {n} levels")
            self.merge_shared = ConvBN(out_channels, out_channels, 3, act=leaky)
        else:
            raise ValueError(f"unknown FPN variant {variant!r}")
        self.nlm = NLM(out_channels, nlm_ch, nlm_psp) if nlm_ch is not None else None
        self.pix = PixelShuffleUp(out_channels) if upsample == "pixelshuffle" else None
        self.n = n

    def _up(self, x, like):
        th, tw = like.shape[2:]
        if self.pix is not None:
            up = self.pix(x)[:, :, :th, :tw]
            if up.shape[2:] != like.shape[2:]:
                raise ValueError(f"pixelshuffle x2 {tuple(x.shape)} cannot reach {tuple(like.shape)}")
        else:
            up = R.resize(x, (th, tw), mode=self.upsample, align_corners=True)
        return self.nlm(up) if self.nlm is not None else up

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"output{i + 1}")(x) for i, x in enumerate(inputs)]
        if self.variant == "cascade":
            outs = [None] * self.n
            outs[-1] = laterals[-1]
            for i in range(self.n - 2, -1, -1):
                up = self._up(outs[i + 1], laterals[i])
                outs[i] = getattr(self, f"merge{i + 1}")(laterals[i] + up)
            return outs
        merge = self.merge_shared
        l1, l2, l3, l4 = laterals
        o1 = merge(l1 + self._up(l2, l1))
        o3 = merge(l3 + self._up(l4, l3))
        o2 = merge(l2 + self._up(o3 if self.variant == "raw152" else l3, l2))
        return [o1, o2, o3, l4]


# ---------------------------------------------------------------------------
# Prediction heads
# ---------------------------------------------------------------------------


class PredictionHead(nn.Module):
    """1x1 conv head -> [B, H*W*A, out_dim] in NHWC flatten order."""

    def __init__(self, cin: int, out_dim: int, num_anchors: int = 2):
        super().__init__()
        self.out_dim = out_dim
        self.conv1x1 = nn.Conv2d(cin, num_anchors * out_dim, 1)

    def forward(self, x):
        y = self.conv1x1(x)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.out_dim)
