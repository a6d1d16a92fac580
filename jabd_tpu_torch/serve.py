"""The serving daemon: dynamic batching over the detect graph behind HTTP.

Port of `BatchingDetector`, `make_server` and `serve` of
`jabd_tpu/serve.py`. A collector thread coalesces concurrent single-image
requests into fixed-size device batches (pad to the batch size), runs them
through the backend's detect graph (a live `Predictor`, or an artifact
loaded by `aot.load_exported`: both take `detect_preprocessed`) and fans
the results back out per request. Every request takes the `detect_image`
path numerically (letterbox -> detect -> letterbox undo), so batching
changes latency, never outputs. On the card every batch launches the NMS
kernel K1, inside the Predictor or inside the artifact's graph.

`serve()` is a stdlib ThreadingHTTPServer speaking JSON:

    POST /detect   image bytes (jpg/png/...) -> {"faces": [[x1, y1, x2, y2,
                   score, 10 landmark coords], ...], "count": N}
    POST /identify image bytes -> {"faces": [{"box", "score", "landmarks",
                   "name", "cosine", "embedding"}, ...], "count": N}
    GET  /healthz  {"requests": N, "batches": M, "occupancy": ...,
                   "wait_mean_ms": ..., "wait_max_ms": ..., ...}

The body is decoded as `cv2.imdecode` decodes it (`eval/run_wider.py::
decode_bgr`: PIL, EXIF orientation applied, BGR); an undecodable body gets
400, an unknown path 404. `/identify` detects through the shared batches,
then aligns and embeds the request's faces on its handler thread
(`IdentityService`); without an embedder it answers 503. A backend over
a local mesh (`Predictor(mesh=)`, `aot.load_exported(mesh=)`) splits each
batch across its replicas, so the batch size must divide the mesh size; a
spatial one (`Predictor(mesh=, partition="spatial")`) splits each image's
rows instead and takes any batch size, 1 included.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.utils import tracing as T


class BatchingDetector:
    """Coalesce concurrent detect requests into batches of `batch_size`.

    `backend` is a Predictor or an `aot.AotDetector`; an artifact's batch
    size must equal `batch_size`, and its input shape and letterbox are
    the manifest's. `max_wait_ms` bounds how long the first request of a
    batch waits for batch-mates.

    `stats()` reports the queue wait, from `detect()` enqueueing a request
    to its batch starting: mean and max in ms over every request batched
    so far. Each batch runs under a `jabd.serve.batch` span while a torch
    profiler records (utils/tracing.py)."""

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
        aot_batch = getattr(backend, "batch_size", None)
        if aot_batch is not None and aot_batch != self.batch_size:
            raise ValueError(
                f"AOT artifact serves batch {aot_batch}; start the "
                f"server with --batch-size {aot_batch}"
            )
        mesh = getattr(backend, "mesh", None)
        # Only the data partition shards the batch axis (spatial shards
        # the height and takes any batch size, 1 included).
        if mesh is not None and getattr(backend, "partition", "data") == "data" and self.batch_size % mesh.size:
            raise ValueError(
                f"batch size {self.batch_size} must divide the serving "
                f"mesh size {mesh.size}"
            )
        self.max_wait_s = max_wait_ms / 1000.0
        pcfg = getattr(backend, "pcfg", None)
        self.input_shape = tuple(input_shape or (pcfg.input_shape if pcfg else backend.input_shape))
        self.letterbox = bool(
            letterbox if letterbox is not None else (pcfg.letterbox if pcfg else backend.letterbox)
        )
        self._q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_waits = 0
        self.wait_total_s = 0.0
        self.wait_max_s = 0.0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def detect(self, image: np.ndarray, timeout: float = 600.0):
        """Blocking single-image detect ([H, W, 3] uint8) -> [N, 15]
        pixel-space dets. Thread-safe; concurrent callers share batches."""
        fut: Future = Future()
        self._q.put((image, fut, time.monotonic()))
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
                "wait_mean_ms": 1000.0 * self.wait_total_s / (self.n_waits or 1),
                "wait_max_ms": 1000.0 * self.wait_max_s,
            }

    # -- collector -----------------------------------------------------------

    def _collect(self) -> List[Tuple[np.ndarray, Future, float]]:
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
            start = time.monotonic()
            waits = [start - t for _, _, t in items]
            with self._stats_lock:
                self.n_waits += len(waits)
                self.wait_total_s += sum(waits)
                self.wait_max_s = max(self.wait_max_s, *waits)
            try:
                with T.span("jabd.serve.batch"):
                    batch = np.zeros((self.batch_size, th, tw, 3), np.float32)
                    for i, (img, _, _) in enumerate(items):
                        batch[i] = I.serving_front_end(img, (tw, th), self.letterbox)
                    dets_b, valid_b = self.backend.detect_preprocessed(batch)
                    dets_b = dets_b.cpu().numpy()
                    valid_b = valid_b.cpu().numpy()
                    for i, (img, fut, _) in enumerate(items):
                        fut.set_result(
                            I.undo_letterbox_pixels(
                                dets_b[i][valid_b[i]], (th, tw), img.shape[:2],
                                self.letterbox,
                            )
                        )
            except Exception as e:  # the worker outlives one bad batch
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)
            with self._stats_lock:
                self.n_requests += len(items)
                self.n_batches += 1


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------


class IdentityService:
    """The `/identify` extension: align a request's detections, embed them
    through a `FacePipeline`'s fixed-batch graph and, with a `Gallery`,
    name them. Detection stays on the BatchingDetector's shared batches;
    only the embedding (112x112 crops) runs per request."""

    def __init__(self, pipeline, gallery=None, threshold: float = 0.3):
        self.pipeline = pipeline
        self.gallery = gallery
        self.threshold = threshold

    def analyze(self, image: np.ndarray, dets: np.ndarray) -> list:
        """BGR image and its [N, 15] pixel-space detections -> one JSON-ready
        dict per face: box, score, landmarks, name, cosine and the
        embedding rounded to 6 places."""
        embs = self.pipeline.embed_detections(image, dets)
        matches = (
            self.gallery.match(embs, threshold=self.threshold)
            if self.gallery is not None and len(embs)
            else [(None, -1.0)] * len(embs)
        )
        return [
            {
                "box": [round(float(v), 3) for v in d[:4]],
                "score": round(float(d[4]), 4),
                "landmarks": [round(float(v), 3) for v in d[5:15]],
                "name": name,
                "cosine": round(float(sim), 4),
                "embedding": np.round(e.astype(np.float64), 6).tolist(),
            }
            for d, e, (name, sim) in zip(dets, embs, matches)
        ]


def make_server(
    detector: BatchingDetector,
    host: str = "127.0.0.1",
    port: int = 8712,
    identity: Optional[IdentityService] = None,
):
    """Build (not start) the ThreadingHTTPServer: its handler threads feed
    the one BatchingDetector, which forms the device batches. Port 0 takes
    a free port (`server.server_address[1]`). `identity` enables
    `/identify`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from jabd_tpu_torch.eval.run_wider import decode_bgr

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, detector.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/identify" and identity is None:
                self._json(503, {"error": "no embedder: start the server with --arch/--ckpt to enable /identify"})
                return
            if self.path not in ("/detect", "/identify"):
                self._json(404, {"error": "unknown path"})
                return
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = decode_bgr(raw)
            except (OSError, ValueError):  # PIL's errors for bytes that are no image
                self._json(400, {"error": "undecodable image"})
                return
            try:
                dets = detector.detect(img)
                if self.path == "/identify":
                    faces = identity.analyze(img, dets)
                    self._json(200, {"faces": faces, "count": len(faces)})
                    return
            except Exception as e:  # the daemon outlives one failed request
                self._json(500, {"error": str(e)})
                return
            self._json(200, {
                "faces": [[round(float(v), 3) for v in d] for d in dets],
                "count": int(len(dets)),
            })

    return ThreadingHTTPServer((host, port), Handler)


def serve(
    detector: BatchingDetector,
    host: str = "127.0.0.1",
    port: int = 8712,
    identity: Optional[IdentityService] = None,
) -> None:
    """Serve until interrupted, then stop the detector's collector."""
    srv = make_server(detector, host, port, identity=identity)
    print(
        f"serving on http://{host}:{srv.server_address[1]} "
        f"(batch {detector.batch_size}, input {detector.input_shape}"
        f"{', /identify enabled' if identity else ''})",
        flush=True,
    )
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        detector.close()
