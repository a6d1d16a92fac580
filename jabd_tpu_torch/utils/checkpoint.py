"""Step-indexed training checkpoints with torch.save.

Port of `CheckpointManager` (jabd_tpu/utils/checkpoint.py, which uses
Orbax): `<directory>/<step>.pt` holds the model's state dict (parameters
and BatchNorm statistics), the optimizer's state dict (Adam moments) and
the step and schedule counts of a `train.TrainState`; the oldest files
beyond `max_to_keep` are deleted. Unlike the reference's per-epoch
`torch.save(model.state_dict())`, a restore also resumes the optimizer.

`partial_load` is the shape-filtered load of jabd_tpu/utils/checkpoint.py
(reference train_mobilenetV3_ecagai.py:450-460).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any) -> None:
        """Write `state.state_dict()` as step `step` (atomically: a
        temporary file renamed), then drop the oldest beyond max_to_keep."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None):
        """Load step `step` (default: the latest) into `state_template`,
        on the device of its model, and return it; None if there is no
        checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        device = next(state_template.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        state_template.load_state_dict(payload)
        return state_template


def partial_load(
    target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Shape-filtered partial load: every entry of the state dict `target`
    whose name is in `source` with the same shape takes the source's value,
    the rest keep the target's. Returns (state dict, count taken), for
    `model.load_state_dict`."""
    out = {}
    n_loaded = 0
    for key, value in target.items():
        src = source.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            out[key] = src
            n_loaded += 1
        else:
            out[key] = value
    return out, n_loaded
