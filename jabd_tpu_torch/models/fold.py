"""BatchNorm folding for eval graphs. Port of `fold_batchnorm`
(jabd_tpu/models/fold.py).

In eval mode a BatchNorm is the per-channel affine y = x * s + t with
s = scale / sqrt(var + eps), t = bias - mean * s; folding it into the
conv before it removes it from the graph. The patterns:
  * ConvBN:    conv + bn           -> conv with bias
  * SEModule:  fc1 + bn (+ fc2)    -> fc1 with bias
  * MNV3Block: skip_pw + skip_pw_bn -> skip_pw with folded bias
A BatchNorm that matches none (EPSABlock's `bn2`, after the PSA
concatenation) stays in place in eval mode, as in the JAX package.
"""

from __future__ import annotations

import torch.nn as nn


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of `model` that follows a conv, in place (in
    float32: fold before casting to bfloat16), and return it."""
    for module in list(model.modules()):
        fold = getattr(module, "fold_", None)
        if fold is not None:
            fold()
    return model
