"""Training loss log. Port of `LossHistory` (jabd_tpu/utils/logging.py,
reference utils/callbacks.py:7-49): one line per epoch appended to
`<log_dir>/loss_<timestamp>/epoch_loss.txt`. The reference's smoothed
loss plot needs matplotlib and is not ported yet."""

from __future__ import annotations

import os
import time
from typing import List


class LossHistory:
    def __init__(self, log_dir: str):
        ts = time.strftime("%Y_%m_%d_%H_%M_%S")
        self.save_path = os.path.join(log_dir, f"loss_{ts}")
        os.makedirs(self.save_path, exist_ok=True)
        self.losses: List[float] = []

    def append_loss(self, loss: float) -> None:
        self.losses.append(float(loss))
        with open(os.path.join(self.save_path, "epoch_loss.txt"), "a") as f:
            f.write(f"{float(loss)}\n")
