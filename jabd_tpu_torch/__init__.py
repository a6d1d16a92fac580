"""JABD detector in PyTorch for one NVIDIA Hopper card (H100).

The port of the JAX package `jabd_tpu`, module for module: `configs`,
`ops/`, `models/`, `predict`, `serve`. It imports torch and numpy only;
the JAX package is the reference its tests hold it against.

Entry points (`Predictor`, `BatchingDetector`, `build_model`) run on
`cuda` unless the caller passes `device="cpu"`. The greedy NMS runs as a
hand-written CUDA kernel (`csrc/nms.cu`), built with nvcc at first use;
importing any module of the package needs neither nvcc nor a card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card. Raises when no device is given and there is no card, so a
    missing GPU never turns into a silent run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
