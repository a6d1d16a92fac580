"""MobileNetV3-Large and MobileNetV1-0.25 backbones, NCHW. Port of
`MNV3Block`, the block tables (the 3- and 4-stage splits),
`MobileNetV3Backbone` and `MobileNetV1Backbone` of
`jabd_tpu/models/mobilenet.py`."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from jabd_tpu_torch.models.layers import ECA, BatchNorm2d, ConvBN, SEModule, fold_conv_bn, hswish, segment


class MNV3Block(nn.Module):
    """Bottleneck: expand 1x1 -> depthwise kxk -> [ECA | SE] -> project 1x1,
    plus a skip path, with the activation applied AFTER the residual sum
    (a reference quirk). ECA, when given, replaces SE: the reference's ECA
    blocks build an SE module and never call it.

    Skip path rules:
      stride 1, in != out: 1x1 ConvBN                     (skip_conv)
      stride 2, in != out: depthwise 3x3 s2 ConvBN, 1x1 conv with bias,
                           BatchNorm                      (skip_dw, skip_pw, skip_pw_bn)
      stride 2, in == out: depthwise 3x3 s2 ConvBN        (skip_dw)
      stride 1, in == out: identity
    """

    def __init__(
        self,
        kernel: int,
        in_size: int,
        expand: int,
        out: int,
        act: str,
        se: bool,
        stride: int,
        eca: Optional[str] = None,
    ):
        super().__init__()
        self.act = F.relu if act == "relu" else hswish
        self.conv1 = ConvBN(in_size, expand, 1, act="none")
        self.conv2 = ConvBN(expand, expand, kernel, stride=stride, groups=expand, act="none")
        if eca is not None:
            self.eca = ECA(expand, statistic=eca, gate="hsigmoid")
        elif se:
            self.se = SEModule(expand)
        self.conv3 = ConvBN(expand, out, 1, act="none")
        self.skip_pw_bn: Optional[nn.BatchNorm2d] = None
        if stride == 1 and in_size != out:
            self.skip_conv = ConvBN(in_size, out, 1, act="none")
        elif stride == 2:
            self.skip_dw = ConvBN(in_size, in_size, 3, stride=2, groups=in_size, act="none")
            if in_size != out:
                self.skip_pw = nn.Conv2d(in_size, out, 1, bias=True)
                self.skip_pw_bn = BatchNorm2d(out)

    def fold_(self) -> None:
        if self.skip_pw_bn is not None:
            self.skip_pw = fold_conv_bn(self.skip_pw, self.skip_pw_bn)
            self.skip_pw_bn = None

    def forward(self, x):
        h = self.act(self.conv1(x))
        h = self.act(self.conv2(h))
        if hasattr(self, "eca"):
            h = self.eca(h)
        elif hasattr(self, "se"):
            h = self.se(h)
        h = self.conv3(h)

        skip = x
        if hasattr(self, "skip_conv"):
            skip = self.skip_conv(x)
        elif hasattr(self, "skip_dw"):
            skip = self.skip_dw(x)
            if hasattr(self, "skip_pw"):
                skip = self.skip_pw(skip)
                if self.skip_pw_bn is not None:
                    skip = self.skip_pw_bn(skip)
        return self.act(h + skip)


# Block spec: (kernel, in, expand, out, act, se, stride)
_L_STAGE1 = [
    (3, 16, 16, 16, "relu", False, 1),
    (3, 16, 64, 24, "relu", False, 2),
    (3, 24, 72, 24, "relu", False, 1),
    (5, 24, 72, 40, "relu", True, 2),
    (5, 40, 120, 40, "relu", True, 1),
    (5, 40, 120, 40, "relu", True, 1),
]
_L_STAGE2 = [
    (3, 40, 240, 80, "hswish", False, 2),
    (3, 80, 200, 80, "hswish", False, 1),
    (3, 80, 184, 80, "hswish", False, 1),
    (3, 80, 184, 80, "hswish", False, 1),
]
_L_STAGE3 = [
    (3, 80, 480, 112, "hswish", True, 1),
    (3, 112, 672, 112, "hswish", True, 1),
    (5, 112, 672, 160, "hswish", True, 2),
    (5, 160, 672, 160, "hswish", True, 1),
    (5, 160, 960, 160, "hswish", True, 1),
]

# 3-stage split: taps at 40 / 80 / 160 channels (strides 8 / 16 / 32).
MNV3_LARGE_3STAGE = [_L_STAGE1, _L_STAGE2, _L_STAGE3]

# 4-stage split: taps at 40 / 80 / 80 / 160 channels (strides 8 / 16 / 16 / 32).
MNV3_LARGE_4STAGE = [
    _L_STAGE1[:4],
    [_L_STAGE1[4], _L_STAGE1[5], _L_STAGE2[0]],
    _L_STAGE2[1:],
    _L_STAGE3,
]


class MobileNetV3Backbone(nn.Module):
    """Stage-split MobileNetV3-Large: stem conv 3x3 s2 -> 16 + BN +
    hswish, then one tap per stage.

    block_attention: None -> plain blocks (SE where the table says);
    'eca' -> avg-ECA in every block; 'eca_g' -> stdv-ECA in stage-1 block
    3 and stage-2 block 2, avg-ECA elsewhere.
    """

    _ECAG_BLOCKS = ((0, 3), (1, 2))

    def __init__(
        self,
        stages: Sequence[Sequence[Tuple]] = MNV3_LARGE_3STAGE,
        block_attention: Optional[str] = None,
    ):
        super().__init__()
        self.stem = ConvBN(3, 16, 3, stride=2, act="none")
        self.stage_names = []
        for si, stage in enumerate(stages):
            names = []
            for bi, (k, cin, exp, cout, act, se, stride) in enumerate(stage):
                eca = None
                if block_attention == "eca":
                    eca = "avg"
                elif block_attention == "eca_g":
                    eca = "stdv" if (si, bi) in self._ECAG_BLOCKS else "avg"
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, MNV3Block(k, cin, exp, cout, act, se, stride, eca))
                names.append(name)
            self.stage_names.append(names)

    def forward(self, x, remat: bool = False):
        """remat checkpoints the stem and each block as a segment."""
        h = segment(lambda t: hswish(self.stem(t)), x, remat)
        taps = []
        for names in self.stage_names:
            for name in names:
                h = segment(getattr(self, name), h, remat)
            taps.append(h)
        return taps


class MobileNetV1Backbone(nn.Module):
    """MobileNetV1 x0.25: a 3x3 s2 stem to 8 channels, then 13 depthwise-
    separable blocks in three stages (block i: depthwise 3x3 ConvBN
    `dw{i}_depth`, pointwise 1x1 ConvBN `dw{i}_point`), taps at 64 / 128 /
    256 channels (strides 8 / 16 / 32), LeakyReLU 0.1 everywhere. Port of
    `MobileNetV1Backbone` of jabd_tpu/models/mobilenet.py."""

    # (out channels, stride) per block, by stage.
    STAGES = (
        ((16, 1), (32, 2), (32, 1), (64, 2), (64, 1)),
        ((128, 2),) + ((128, 1),) * 5,
        ((256, 2), (256, 1)),
    )

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 8, 3, stride=2, act=0.1)
        cin, i = 8, 0
        for plan in self.STAGES:
            for cout, stride in plan:
                self.add_module(f"dw{i}_depth", ConvBN(cin, cin, 3, stride=stride, act=0.1, groups=cin))
                self.add_module(f"dw{i}_point", ConvBN(cin, cout, 1, act=0.1))
                cin, i = cout, i + 1

    def _block(self, i: int):
        depth, point = getattr(self, f"dw{i}_depth"), getattr(self, f"dw{i}_point")
        return lambda t: point(depth(t))

    def forward(self, x, remat: bool = False):
        """remat checkpoints the stem and each block as a segment."""
        h = segment(self.stem, x, remat)
        taps, i = [], 0
        for plan in self.STAGES:
            for _ in plan:
                h = segment(self._block(i), h, remat)
                i += 1
            taps.append(h)
        return taps
