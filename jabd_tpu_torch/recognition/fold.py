"""BatchNorm folding for the IR backbones' eval graphs.

Port of `fold_ir` (jabd_tpu/recognition/fold.py). Each conv of the IR
layout is directly followed by its BatchNorm (conv1 -> bn1, conv2 -> bn2,
conv3 -> bn3, shortcut_conv -> shortcut_bn, input_conv -> input_bn), and
the projection `fc` by `features_bn`, an affine-free BatchNorm1d that
folds into it as a scale of its output rows plus a bias. The
pre-activation BatchNorms (`bn0`, `output_bn`) precede their convs and
stay: folding an affine into a zero-padded conv's input would change what
the padding means. Each block's and the backbone's `fold_()`
(recognition/net.py) does the work; `models/fold.fold_batchnorm` walks
them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.models.layers import BN_EPS


def fold_linear_bn(fc: nn.Linear, bn: nn.BatchNorm1d) -> nn.Linear:
    """A Linear computing `fc` followed by the eval-mode affine-free `bn`:
    s = 1 / sqrt(var + eps), weight rows * s, bias (b - mean) * s."""
    s = 1.0 / torch.sqrt(bn.running_var + BN_EPS)
    out = nn.Linear(fc.in_features, fc.out_features, device=fc.weight.device, dtype=fc.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(fc.weight * s[:, None])
        out.bias.copy_((fc.bias - bn.running_mean) * s)
    return out


def fold_ir(model: nn.Module) -> nn.Module:
    """Fold every foldable BatchNorm of an IR backbone in place (in
    float32: fold before casting to bfloat16) and return it."""
    return fold_batchnorm(model)
