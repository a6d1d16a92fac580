"""Training loss log. Port of `LossHistory` (jabd_tpu/utils/logging.py,
reference utils/callbacks.py:7-49): one line per epoch appended to
`<log_dir>/loss_<timestamp>/epoch_loss.txt`, and the loss curve with its
savgol-smoothed line redrawn to `epoch_loss.png` after every epoch. A
second history made in the same second gets `loss_<timestamp>_1` (and so
on), which sorts after the first, so two fit calls never share a log.
matplotlib and scipy are imported only to plot: without matplotlib only
the txt file is written. A failing plot never stops training."""

from __future__ import annotations

import os
import time
import warnings
from typing import List


class LossHistory:
    def __init__(self, log_dir: str):
        ts = time.strftime("%Y_%m_%d_%H_%M_%S")
        self.save_path = os.path.join(log_dir, f"loss_{ts}")
        n = 0
        while os.path.exists(self.save_path):
            n += 1
            self.save_path = os.path.join(log_dir, f"loss_{ts}_{n}")
        os.makedirs(self.save_path)
        self.losses: List[float] = []
        self.plot = True  # False once matplotlib is found missing

    def append_loss(self, loss: float) -> None:
        self.losses.append(float(loss))
        with open(os.path.join(self.save_path, "epoch_loss.txt"), "a") as f:
            f.write(f"{float(loss)}\n")
        if self.plot:
            self._plot()

    def _plot(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            self.plot = False  # no plotting library: the txt file only
            return
        try:
            it = range(len(self.losses))
            plt.figure()
            plt.plot(it, self.losses, "red", linewidth=2, label="train loss")
            if len(self.losses) >= 7:
                from scipy.signal import savgol_filter

                num = 5 if len(self.losses) < 25 else 15
                plt.plot(
                    it, savgol_filter(self.losses, num, 3), "green",
                    linestyle="--", linewidth=2, label="smooth train loss",
                )
            plt.grid(True)
            plt.xlabel("Epoch")
            plt.ylabel("Loss")
            plt.legend(loc="upper right")
            plt.savefig(os.path.join(self.save_path, "epoch_loss.png"))
        except Exception as e:  # the plot must never stop training
            warnings.warn(f"loss plot not written: {e!r}")
        finally:
            plt.close("all")
