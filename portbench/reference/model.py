"""Plain PyTorch reference of the benchmark's two detectors.

The reference repository's RetinaFace assemblies (github.com/liudabao001/
JABD-Joint-Attention-Based-Detector-for-small-face-detection:
train_mobilenetV3_ecagai.py:319-435 for `jabd_flagship`,
nets/retinaface_eca_nonlocal.py for `re50_eca_nonlocal`) written out from
the numbers of a configuration file, in float32 with plain torch modules:

  backbone taps -> [tap ECA] -> cascade FPN (upsample + NLM) -> [shared
  ECA] -> SSH -> per-level 1x1 heads -> (loc [B,P,4], conf [B,P,2],
  landm [B,P,10]), softmax on conf in eval mode.

BatchNorm stays a BatchNorm (eval: running statistics; train: batch
statistics); nothing is folded or cast. Submodule names follow the
served program's state-dict layout, so one state dict loads into both.
This file imports torch only.

`set_fp8(model)` makes every convolution compute in float8: inputs,
weights and outputs rounded to e4m3 and their gradients to e5m2 (one
scale per tensor, float32 accumulation): the lower-precision control of
the comparisons.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 `dtype` under one scale (absmax to `top`)."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2, as
    float8 training keeps activations and weights in e4m3 and gradients
    in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (absmax to 448), back in
    x's dtype; its gradient rounded to e5m2."""
    return _FP8.apply(x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, when `fp8`, rounds its input, weight and output to
    float8 (float32 accumulation in between, as a float8 pipeline keeps)."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return fp8_round(self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias))


def set_fp8(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.fp8 = True
    return model


def act_fn(act):
    if act == "relu":
        return F.relu
    if act == "hswish":
        return hswish
    if act == "none":
        return lambda x: x
    return lambda x: F.leaky_relu(x, negative_slope=float(act))


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm, but in training the running variance takes the
    batch's biased variance, as the served package states (flax's
    BatchNorm): running = 0.9 running + 0.1 batch, for the mean and the
    biased variance alike."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.float()
            mean, var = xf.mean((0, 2, 3)), xf.var((0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBN(nn.Module):
    """Conv (no bias, 'same' padding) + BatchNorm + activation (a name, or
    a LeakyReLU slope)."""

    def __init__(self, cin, cout, kernel=3, stride=1, act=0.0, groups=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS, momentum=0.1)
        self.act = act_fn(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


def eca_kernel_size(channels: int) -> int:
    """ECA's adaptive kernel: |log2(C) + 1| / 2, made odd."""
    k = int(abs((math.log(channels, 2) + 1) / 2))
    return k if k % 2 else k + 1


class ECA(nn.Module):
    """Channel attention: a k-tap 1-D conv across the channels of the
    spatial mean ('avg') or population standard deviation ('stdv'),
    gated by sigmoid or hsigmoid, times the input."""

    def __init__(self, channels: int, statistic: str, gate: str):
        super().__init__()
        k = eca_kernel_size(channels)
        self.conv1d = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.statistic = statistic
        self.gate = torch.sigmoid if gate == "sigmoid" else hsigmoid

    def forward(self, x):
        if self.statistic == "stdv":
            stat = torch.sqrt(((x - x.mean(dim=(2, 3), keepdim=True)) ** 2).mean(dim=(2, 3)))
        else:
            stat = x.mean(dim=(2, 3))
        return x * self.gate(self.conv1d(stat[:, None, :])[:, 0])[:, :, None, None]


class MNV3Block(nn.Module):
    """MobileNetV3 bottleneck with avg-ECA after the depthwise conv (the
    reference's Block_eca; its SE module is built but never called), the
    activation after the residual sum, and its skip-path rules."""

    def __init__(self, kernel, cin, expand, cout, act, stride):
        super().__init__()
        self.act = F.relu if act == "relu" else hswish
        self.conv1 = ConvBN(cin, expand, 1, act="none")
        self.conv2 = ConvBN(expand, expand, kernel, stride=stride, groups=expand, act="none")
        self.eca = ECA(expand, "avg", "hsigmoid")
        self.conv3 = ConvBN(expand, cout, 1, act="none")
        self.skip = "identity"
        if stride == 1 and cin != cout:
            self.skip_conv = ConvBN(cin, cout, 1, act="none")
            self.skip = "conv"
        elif stride == 2:
            self.skip_dw = ConvBN(cin, cin, 3, stride=2, groups=cin, act="none")
            self.skip = "dw"
            if cin != cout:
                self.skip_pw = Conv2d(cin, cout, 1, bias=True)
                self.skip_pw_bn = BatchNorm2d(cout, eps=BN_EPS, momentum=0.1)
                self.skip = "dw_pw"

    def forward(self, x):
        h = self.act(self.conv1(x))
        h = self.act(self.conv2(h))
        h = self.conv3(self.eca(h))
        if self.skip == "conv":
            x = self.skip_conv(x)
        elif self.skip != "identity":
            x = self.skip_dw(x)
            if self.skip == "dw_pw":
                x = self.skip_pw_bn(self.skip_pw(x))
        return self.act(h + x)


# (kernel, in, expand, out, activation, stride) per block, by stage: the
# MobileNetV3-Large table split at its 40, 80 and 160 channel taps.
MNV3_STAGES = (
    ((3, 16, 16, 16, "relu", 1), (3, 16, 64, 24, "relu", 2), (3, 24, 72, 24, "relu", 1),
     (5, 24, 72, 40, "relu", 2), (5, 40, 120, 40, "relu", 1), (5, 40, 120, 40, "relu", 1)),
    ((3, 40, 240, 80, "hswish", 2), (3, 80, 200, 80, "hswish", 1), (3, 80, 184, 80, "hswish", 1),
     (3, 80, 184, 80, "hswish", 1)),
    ((3, 80, 480, 112, "hswish", 1), (3, 112, 672, 112, "hswish", 1), (5, 112, 672, 160, "hswish", 2),
     (5, 160, 672, 160, "hswish", 1), (5, 160, 960, 160, "hswish", 1)),
)


class MobileNetV3(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 16, 3, stride=2, act="hswish")
        self.stages = []
        for si, stage in enumerate(MNV3_STAGES):
            names = []
            for bi, spec in enumerate(stage):
                names.append(f"layer{si + 1}_block{bi}")
                self.add_module(names[-1], MNV3Block(*spec))
            self.stages.append(names)

    def forward(self, x) -> List[torch.Tensor]:
        h, taps = self.stem(x), []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        return taps


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 1, act="relu")
        self.conv2 = ConvBN(planes, planes, 3, stride=stride, act="relu")
        self.conv3 = ConvBN(planes, planes * 4, 1, act="none")
        if downsample:
            self.downsample = ConvBN(cin, planes * 4, 1, stride=stride, act="none")

    def forward(self, x):
        skip = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + skip)


class ResNet50(nn.Module):
    """torchvision's ResNet-50 (stride on the 3x3), tapped after layers 2-4."""

    BLOCKS, PLANES = (3, 4, 6, 3), (64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, stride=2, act="relu")
        self.stages, cin = [], 64
        for si, (n, p) in enumerate(zip(self.BLOCKS, self.PLANES)):
            names = []
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                names.append(f"layer{si + 1}_block{bi}")
                self.add_module(names[-1], Bottleneck(cin, p, stride, bi == 0))
                cin = p * 4
            self.stages.append(names)

    def forward(self, x) -> List[torch.Tensor]:
        h, taps = F.max_pool2d(self.stem(x), 3, 2, 1), []
        for si, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if si > 0:
                taps.append(h)
        return taps


class NLM(nn.Module):
    """Non-local block with keys and values pooled to a pyramid of s x s
    grids: W(softmax(q k^T) v) + x."""

    def __init__(self, channels, ch, psp_sizes):
        super().__init__()
        self.ch, self.psp_sizes = ch, tuple(psp_sizes)
        self.f_query = Conv2d(channels, ch, 1)
        self.f_key = Conv2d(channels, ch, 1)
        self.f_value = Conv2d(channels, ch, 1)
        self.W = Conv2d(ch, channels, 1)

    def pool(self, x):
        return torch.cat([F.adaptive_avg_pool2d(x, s).flatten(2) for s in self.psp_sizes], 2).transpose(1, 2)

    def forward(self, x):
        b, _, h, w = x.shape
        q = self.f_query(x).flatten(2).transpose(1, 2)
        k, v = self.pool(self.f_key(x)), self.pool(self.f_value(x))
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
        ctx = torch.bmm(attn, v).transpose(1, 2).reshape(b, self.ch, h, w)
        return self.W(ctx) + x


class SSH(nn.Module):
    def __init__(self, c):
        super().__init__()
        leaky = 0.1 if c <= 64 else 0.0
        self.conv3x3 = ConvBN(c, c // 2, 3, act="none")
        self.conv5x5_1 = ConvBN(c, c // 4, 3, act=leaky)
        self.conv5x5_2 = ConvBN(c // 4, c // 4, 3, act="none")
        self.conv7x7_2 = ConvBN(c // 4, c // 4, 3, act=leaky)
        self.conv7x7_3 = ConvBN(c // 4, c // 4, 3, act="none")

    def forward(self, x):
        c5 = self.conv5x5_1(x)
        return F.relu(torch.cat([self.conv3x3(x), self.conv5x5_2(c5), self.conv7x7_3(self.conv7x7_2(c5))], 1))


class FPN(nn.Module):
    """Cascade FPN: 1x1 laterals; from the top down, each level adds the
    upsampled (then NLM'd) merged level above and runs its 3x3 merge."""

    def __init__(self, in_channels: Sequence[int], c: int, upsample: str, nlm: Optional[dict]):
        super().__init__()
        leaky = 0.1 if c <= 64 else 0.0
        for i, cin in enumerate(in_channels):
            self.add_module(f"output{i + 1}", ConvBN(cin, c, 1, act=leaky))
        for i in range(len(in_channels) - 1):
            self.add_module(f"merge{i + 1}", ConvBN(c, c, 3, act=leaky))
        self.nlm = NLM(c, nlm["ch"], nlm["psp_sizes"]) if nlm else None
        self.upsample, self.n = upsample, len(in_channels)

    def up(self, x, like):
        size = like.shape[2:]
        if tuple(x.shape[2:]) != tuple(size):
            if self.upsample == "nearest":
                x = F.interpolate(x, size=size, mode="nearest")
            else:
                x = F.interpolate(x, size=size, mode=self.upsample, align_corners=True)
        return self.nlm(x) if self.nlm is not None else x

    def forward(self, taps):
        lat = [getattr(self, f"output{i + 1}")(t) for i, t in enumerate(taps)]
        outs = [None] * self.n
        outs[-1] = lat[-1]
        for i in range(self.n - 2, -1, -1):
            outs[i] = getattr(self, f"merge{i + 1}")(lat[i] + self.up(outs[i + 1], lat[i]))
        return outs


class Head(nn.Module):
    def __init__(self, cin, dim, anchors):
        super().__init__()
        self.dim = dim
        self.conv1x1 = Conv2d(cin, anchors * dim, 1)

    def forward(self, x):
        y = self.conv1x1(x)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.dim)


class RetinaFace(nn.Module):
    """The detector of a configuration file's `model` block."""

    def __init__(self, m: dict, mode: str = "eval"):
        super().__init__()
        if m["backbone"] == "mobilenet_v3_large":
            if m["backbone_block_attention"] != "eca" or m["num_levels"] != 3:
                raise ValueError("the reference builds the 3-level MobileNetV3 with ECA blocks only")
            self.backbone = MobileNetV3()
        elif m["backbone"] == "resnet50":
            self.backbone = ResNet50()
        else:
            raise ValueError(f"no reference for backbone {m['backbone']!r}")
        if m["fpn_variant"] != "cascade":
            raise ValueError("the reference builds the cascade FPN only")
        self.mode = mode
        kind = {"eca": "avg", "eca_stdv": "stdv"}
        self.tap_eca = m["tap_attention"] is not None
        if self.tap_eca:
            for i, c in enumerate(m["in_channels"]):
                self.add_module(f"eca_tap{i + 1}", ECA(c, kind[m["tap_attention"]], m["eca_gate"]))
        c = m["out_channels"]
        self.fpn = FPN(m["in_channels"], c, m["fpn_upsample"], m["nlm"])
        self.eca_fpn = ECA(c, kind[m["fpn_attention"]], m["eca_gate"]) if m["fpn_attention"] else None
        self.levels = m["num_levels"]
        for i in range(self.levels):
            self.add_module(f"ssh{i + 1}", SSH(c))
            for name, dim in (("bbox_head", 4), ("class_head", 2), ("landmark_head", 10)):
                self.add_module(f"{name}{i + 1}", Head(c, dim, m["anchors_per_cell"]))

    def forward(self, x):
        taps = self.backbone(x)
        if self.tap_eca:
            taps = [getattr(self, f"eca_tap{i + 1}")(t) for i, t in enumerate(taps)]
        feats = self.fpn(taps)
        if self.eca_fpn is not None:
            feats = [self.eca_fpn(f) for f in feats]
        feats = [getattr(self, f"ssh{i + 1}")(f) for i, f in enumerate(feats)]

        def heads(name):
            return torch.cat([getattr(self, f"{name}{i + 1}")(f) for i, f in enumerate(feats)], 1).float()

        loc, conf, landm = heads("bbox_head"), heads("class_head"), heads("landmark_head")
        if self.mode == "eval":
            conf = torch.softmax(conf, dim=-1)
        return loc, conf, landm
