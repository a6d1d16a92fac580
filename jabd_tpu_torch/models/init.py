"""The reference's from-scratch weight initialization.

Port of `jabd_tpu/models/init.py::reference_weights_init`, which
reproduces `weights_init(net, init_type='normal', init_gain=0.02)` of
nets/retinaface_training.py:305-324 as the reference's train scripts
apply it when no pretrained weights are given:

  * Conv2d and the ECA Conv1d: weight ~ N(0, gain^2) ('normal'), or
    xavier / kaiming / orthogonal; their biases keep torch's Conv default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in));
  * BatchNorm: weight ~ N(1, 0.02^2) whatever the gain, bias = 0;
  * nothing else is touched.

The fans are the JAX package's: fan_in = k*k*C_in/groups, fan_out = C_out.
Random numbers come from an explicit torch.Generator, so the draws differ
from the JAX package's (the tests compare statistics).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def _conv_weight_(w: torch.Tensor, init_type: str, gain: float, g: torch.Generator) -> None:
    fan_in = w[0].numel()
    fan_out = w.shape[0]
    if init_type == "normal":
        nn.init.normal_(w, 0.0, gain, generator=g)
    elif init_type == "xavier":
        nn.init.normal_(w, 0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=g)
    elif init_type == "kaiming":
        nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in), generator=g)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain, generator=g)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


@torch.no_grad()
def reference_weights_init(
    model: nn.Module,
    generator: torch.Generator,
    init_type: str = "normal",
    init_gain: float = 0.02,
) -> nn.Module:
    """Re-draw `model`'s conv and BatchNorm parameters in place (on the
    CPU: `generator` must be a CPU generator) and return it."""
    if init_type == "none":
        return model
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            _conv_weight_(m.weight, init_type, init_gain, generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 1.0, 0.02, generator=generator)
            nn.init.zeros_(m.bias)
    return model
