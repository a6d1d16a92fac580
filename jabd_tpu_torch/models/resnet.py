"""ResNet backbones, NCHW. Port of `Bottleneck`, `RESNET_SPECS`,
`ResNetBackbone` and `build_resnet` of `jabd_tpu/models/resnet.py`:
torchvision's bottleneck ResNet-v1 (the stride on the 3x3 conv), tapped
at the stages the reference's detectors read, including the 4-level
ResNet-152 taps and the 5-stage "_self" variants.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from jabd_tpu_torch.models.layers import ConvBN, segment


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4 channels), ReLU after the first two
    BatchNorms and after the residual sum; the skip is a 1x1 ConvBN with
    the stride when the shape changes (`downsample`)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = ConvBN(cin, planes, 1, act="relu")
        self.conv2 = ConvBN(planes, planes, 3, stride=stride, act="relu")
        self.conv3 = ConvBN(planes, cout, 1, act="none")
        if downsample:
            self.downsample = ConvBN(cin, cout, 1, stride=stride, act="none")

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        skip = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + skip)


# name -> (blocks per stage, planes per stage, tapped stage indices)
RESNET_SPECS = {
    "resnet50": ([3, 4, 6, 3], [64, 128, 256, 512], (1, 2, 3)),
    "resnet101": ([3, 4, 23, 3], [64, 128, 256, 512], (1, 2, 3)),
    "resnet152": ([3, 8, 36, 3], [64, 128, 256, 512], (1, 2, 3)),
    # The 4-level ResNet-152 taps layer1..4.
    "resnet152_l4": ([3, 8, 36, 3], [64, 128, 256, 512], (0, 1, 2, 3)),
    # 5-stage "_self" variants: layer4 at 256 planes, an extra layer5.
    "resnet50_self": ([3, 4, 2, 4, 3], [64, 128, 256, 256, 512], (1, 2, 3, 4)),
    "resnet101_self": ([3, 4, 11, 12, 3], [64, 128, 256, 256, 512], (1, 2, 3, 4)),
    "resnet152_self": ([3, 8, 18, 18, 3], [64, 128, 256, 256, 512], (1, 2, 3, 4)),
}


class ResNetBackbone(nn.Module):
    """Stage-tapped ResNet: a 7x7/2 ConvBN + ReLU stem, torch's
    MaxPool2d(3, 2, 1) (its padding is -inf, as in the JAX package), then
    the stages of `block(cin, planes, stride, downsample)`: the first block
    of a stage strides (stage 1 excepted) and downsamples when the shape
    changes. Returns the feature maps of the stages in `taps`."""

    def __init__(
        self,
        blocks: Sequence[int] = (3, 4, 6, 3),
        planes: Sequence[int] = (64, 128, 256, 512),
        taps: Tuple[int, ...] = (1, 2, 3),
        block=Bottleneck,
    ):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, stride=2, act="relu")
        self.taps = tuple(taps)
        self.stage_names = []
        cin = 64
        for si, (n, p) in enumerate(zip(blocks, planes)):
            names = []
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                down = bi == 0 and (stride != 1 or cin != p * 4)
                names.append(f"layer{si + 1}_block{bi}")
                self.add_module(names[-1], block(cin, p, stride, down))
                cin = p * 4
            self.stage_names.append(names)

    def forward(self, x, remat: bool = False):
        """remat checkpoints the stem (with its pool) and each block as a
        segment."""
        h = segment(lambda t: F.max_pool2d(self.stem(t), 3, 2, 1), x, remat)
        taps = []
        for si, names in enumerate(self.stage_names):
            for name in names:
                h = segment(getattr(self, name), h, remat)
            if si in self.taps:
                taps.append(h)
        return taps


def build_resnet(name: str) -> ResNetBackbone:
    blocks, planes, taps = RESNET_SPECS[name]
    return ResNetBackbone(blocks, planes, taps)
