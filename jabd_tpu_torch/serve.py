"""Dynamic batching over a `Predictor`. Port of `BatchingDetector`
(jabd_tpu/serve.py).

A collector thread coalesces concurrent single-image requests into
fixed-size device batches (pad to the batch size), runs them through the
predictor's detect graph and fans the results back out per request.
Every request takes the `detect_image` path numerically (letterbox ->
detect -> letterbox undo), so batching changes latency, never outputs.
The HTTP front end comes with a later slice.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.predict import undo_letterbox_pixels


class BatchingDetector:
    """Coalesce concurrent detect requests into batches of `batch_size`.

    `max_wait_ms` bounds how long the first request of a batch waits for
    batch-mates."""

    def __init__(
        self,
        backend,
        batch_size: int = 8,
        max_wait_ms: float = 15.0,
        input_shape: Optional[Tuple[int, int]] = None,
        letterbox: Optional[bool] = None,
    ):
        self.backend = backend
        self.batch_size = int(batch_size)
        self.max_wait_s = max_wait_ms / 1000.0
        pcfg = backend.pcfg
        self.input_shape = tuple(input_shape or pcfg.input_shape)
        self.letterbox = bool(pcfg.letterbox if letterbox is None else letterbox)
        self._q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def detect(self, image: np.ndarray, timeout: float = 600.0):
        """Blocking single-image detect ([H, W, 3] uint8) -> [N, 15]
        pixel-space dets. Thread-safe; concurrent callers share batches."""
        fut: Future = Future()
        self._q.put((image, fut))
        return fut.result(timeout=timeout)

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the collector
        self._worker.join(timeout=5)

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "batch_size": self.batch_size,
                "occupancy": self.n_requests / (self.n_batches or 1),
                "input_shape": list(self.input_shape),
            }

    # -- collector -----------------------------------------------------------

    def _collect(self) -> List[Tuple[np.ndarray, Future]]:
        """Block for the first request, then gather batch-mates until the
        batch fills or max_wait elapses."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self):
        th, tw = self.input_shape
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            try:
                batch = np.zeros((self.batch_size, th, tw, 3), np.float32)
                for i, (img, _) in enumerate(items):
                    batch[i] = I.serving_front_end(img, (tw, th), self.letterbox)
                dets_b, valid_b = self.backend.detect_preprocessed(batch)
                dets_b = dets_b.cpu().numpy()
                valid_b = valid_b.cpu().numpy()
                for i, (img, fut) in enumerate(items):
                    fut.set_result(
                        undo_letterbox_pixels(
                            dets_b[i][valid_b[i]], (th, tw), img.shape[:2],
                            self.letterbox,
                        )
                    )
            except Exception as e:  # the worker outlives one bad batch
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            with self._stats_lock:
                self.n_requests += len(items)
                self.n_batches += 1
