"""EPSANet-50, NCHW. Port of `SEWeight`, `PSAModule`, `EPSABlock` and
`EPSANetBackbone` of `jabd_tpu/models/epsa.py`: a ResNet whose 3x3 conv
is a pyramid split attention (four grouped convs of kernel 3/5/7/9, each
split reweighted by one shared SE module, softmax across the splits),
five stages of 64/128/256/256/512 planes, taps layer2..5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from jabd_tpu_torch.models.layers import BatchNorm2d, ConvBN
from jabd_tpu_torch.models.resnet import ResNetBackbone

# (blocks per stage, planes per stage, tapped stage indices) of epsanet50.
EPSANET50_SPEC = ([3, 4, 2, 4, 3], [64, 128, 256, 256, 512], (1, 2, 3, 4))


class SEWeight(nn.Module):
    """Squeeze-excite weights: GAP -> 1x1 (C // 16) -> ReLU -> 1x1 (C) ->
    sigmoid, both convs WITH biases. [B, C, H, W] -> [B, C, 1, 1]."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        return torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))))


class PSAModule(nn.Module):
    """Four convs of `planes // 4` channels each (kernels 3/5/7/9, groups
    1/4/8/16, the stride on all), one SE module shared by the four splits,
    a softmax of its weights across the splits, and the weighted splits
    concatenated in REVERSED order (split 4 first), as the reference
    recombines them."""

    def __init__(
        self,
        cin: int,
        planes: int,
        stride: int = 1,
        conv_kernels: Tuple[int, ...] = (3, 5, 7, 9),
        conv_groups: Tuple[int, ...] = (1, 4, 8, 16),
    ):
        super().__init__()
        split = planes // 4
        for i, (k, g) in enumerate(zip(conv_kernels, conv_groups)):
            self.add_module(
                f"conv_{i + 1}",
                nn.Conv2d(cin, split, k, stride=stride, padding=k // 2, groups=g, bias=False),
            )
        self.se = SEWeight(split)
        self.n = len(conv_kernels)

    def forward(self, x):
        feats = torch.stack([getattr(self, f"conv_{i + 1}")(x) for i in range(self.n)], dim=1)
        weights = torch.softmax(torch.stack([self.se(f) for f in feats.unbind(1)], dim=1), dim=1)
        weighted = feats * weights  # [B, 4, C/4, H, W]
        return torch.cat([weighted[:, i] for i in range(self.n - 1, -1, -1)], dim=1)


class EPSABlock(nn.Module):
    """Bottleneck with PSAModule as its 3x3: conv1 (1x1 ConvBN + ReLU) ->
    psa -> bn2 (a BatchNorm of its own, which no conv precedes and
    `fold_batchnorm` leaves in place) -> ReLU -> conv3 (1x1 ConvBN, x4) ->
    + skip (1x1 ConvBN `downsample` when the shape changes) -> ReLU."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = ConvBN(cin, planes, 1, act="relu")
        self.psa = PSAModule(planes, planes, stride=stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = ConvBN(planes, cout, 1, act="none")
        if downsample:
            self.downsample = ConvBN(cin, cout, 1, stride=stride, act="none")

    def forward(self, x):
        out = self.conv3(F.relu(self.bn2(self.psa(self.conv1(x)))))
        skip = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + skip)


class EPSANetBackbone(ResNetBackbone):
    """EPSANet-50: the ResNet stem, max pool and stages, with EPSABlocks
    (`EPSANET50_SPEC`, read when the backbone is built)."""

    def __init__(self):
        blocks, planes, taps = EPSANET50_SPEC
        super().__init__(blocks, planes, taps, block=EPSABlock)
