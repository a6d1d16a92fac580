"""Batch detection in a closed loop: one caller sends the next batch of
uint8 images to `Predictor.detect_images` when the last one returned.

Traffic parameters (portbench/traffic/<name>.json, "driver": "detect"):
image_width, aspects, per_aspect (images of each aspect ratio in a batch),
pool_batches, input_size, confidence, pre_nms_topk (a count, or "all" for
every prior), nms_iou, nms_kind, max_detections, calibration_images,
warmup_calls, check_batches.

Set-up: the image pool and the weights from the seed (the reference
model's seeded, BatchNorm-calibrated state dict, handed to the
Predictor, which folds and casts it as for any user), then
`warmup_calls` calls. The window: calls back to back for the run's
seconds; each call is timed from the call to its returned detections.
After the window: the program is freed, and `check_batches` of the
window's calls, drawn from the seed (each of another pool batch), are
held to the float32 reference (reference/detect.py): each number is the
served detections' departure from the reference's rows over the
departure of plain bfloat16 inference of the reference.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench import counts, generators as G, tracing
from portbench.drivers.common import (Outcome, Phases, device_line, nearest_rank, port_model_config,
                                      reference_precision, release, reset_peak, sync)
from portbench.reference import detect as RD
from portbench.reference.model import RetinaFace, set_fp8


def settings(traffic: dict, num_priors: int) -> dict:
    k = traffic["pre_nms_topk"]
    return {"confidence": traffic["confidence"], "nms_iou": traffic["nms_iou"],
            "max_detections": traffic["max_detections"],
            "pre_nms_topk": num_priors if k == "all" else int(k)}


class Context:
    """What the per-layer readers of a traced detection run read."""

    driver = "detect"

    def __init__(self, trace, served, pool, cell, ref_model, priors, setting, dev):
        self.trace, self.served, self.pool, self.cell = trace, served, pool, cell
        self.ref_model, self.priors, self.settings, self.dev = ref_model, priors, setting, dev
        self.calls = len(served)
        self.images = sum(len(pool[i]) for i in served)
        self._k1 = None

    def flops_per_image(self) -> int:
        h, w = self.cell.traffic["input_size"]
        return counts.model_flops(lambda: RetinaFace(self.cell.config["model"], "eval"), (1, 3, h, w), backward=False)

    def k1_bound_s(self) -> float:
        """The least time of K1 over the traced calls: per batch the larger
        of its operations (the reference's greedy NMS of its candidates) at
        the float32 peak and its bytes at the memory peak."""
        if self._k1 is None:
            per_batch = {}
            for i in sorted(set(self.served)):
                with reference_precision():
                    rows = RD.forward_rows(self.ref_model, self.pool[i], self.cell.traffic["input_size"], self.priors,
                                           self.cell.config["model"]["anchors"]["variance"], self.dev)
                cand, valid = RD.candidates(rows, self.settings)
                keep = RD.greedy_keep(cand[..., :4].contiguous(), valid, self.settings["nms_iou"])
                per_batch[i] = counts.bound_s(counts.nms_ops(keep, valid), counts.nms_bytes(*valid.shape))
            self._k1 = sum(per_batch[i] for i in self.served)
        return self._k1


def _stale(detect):
    """Each call returns the previous call's detections."""
    last = []

    def call(images):
        out = detect(images)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return call


def _half(detect):
    """The second half of each batch gets no detections."""
    def call(images):
        out = detect(images)
        h = len(out) // 2
        return out[:h] + [np.zeros((0, 15), np.float32) for _ in out[h:]]
    return call


def _altered(detect):
    """The answers of the first two images trade places."""
    def call(images):
        out = list(detect(images))
        out[0], out[1] = out[1], out[0]
        return out
    return call


# Faults planted under the served call, for the limits tool and the tests.
FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def run(cell, seed, seconds, trace, t_start, device=None, variant=None, fault=None) -> Outcome:
    from jabd_tpu_torch import configs as C
    from jabd_tpu_torch.predict import Predictor

    dev = torch.device(device or "cuda")
    phases = Phases(t_start, dev)
    tr, cfg = cell.traffic, cell.config
    port_cfg = port_model_config(cfg)
    target = tuple(tr["input_size"])
    pool = G.detect_pool(tr, seed, dev)
    phases.mark("images")
    priors = RD.anchors(cfg["model"]["anchors"], target).to(dev)
    variances = cfg["model"]["anchors"]["variance"]
    setting = settings(tr, priors.shape[0])

    ref = RetinaFace(cfg["model"], "eval").to(dev)
    G.seed_weights(ref, G.torch_gen(seed, 3, dev))
    with reference_precision():
        calib = torch.stack([RD.letterbox(im, target, dev) for im in pool[0][:tr["calibration_images"]]])
        G.calibrate_batchnorms(ref, calib)
    state = {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}
    del ref, calib
    release(dev)
    reset_peak(dev)
    phases.mark("weights")

    pcfg = C.PredictConfig(
        confidence=tr["confidence"], nms_iou=tr["nms_iou"], nms_kind=tr["nms_kind"], input_shape=target,
        letterbox=True, max_detections=tr["max_detections"], pre_nms_topk=setting["pre_nms_topk"],
    )
    if variant == "fp8":
        predictor = RetinaFace(cfg["model"], "eval").to(dev)
        predictor.load_state_dict(state)
        set_fp8(predictor.eval())

        def served_call(images):
            with reference_precision():
                return RD.reference_detect(predictor, images, target, priors, variances, setting, dev, "float8")
    elif variant is None:
        predictor = Predictor(port_cfg, state, pcfg, device=dev)
        served_call = predictor.detect_images
    else:
        raise ValueError(f"no control {variant!r} for detection")
    detect = served_call if fault is None else fault(served_call)
    phases.mark("Predictor")
    for i in range(tr["warmup_calls"]):
        detect(pool[i % len(pool)])
    sync(dev)
    setup_s = time.perf_counter() - t_start
    phases.mark("warm-up calls")
    phases.report()

    served, results, latency = [], [], []
    window = tracing.Window(dev) if trace else contextlib.nullcontext()
    with window:
        t0 = time.perf_counter()
        while True:
            i = len(served) % len(pool)
            c0 = time.perf_counter()
            with torch.profiler.record_function("portbench.detect_images"):
                out = detect(pool[i])
            latency.append(time.perf_counter() - c0)
            served.append(i)
            results.append(out)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    device_info = device_line(dev)
    del predictor, detect, served_call
    release(dev)

    batch = len(pool[0])
    failed = sum(not _well_formed(out, batch, tr["max_detections"]) for out in results)
    end_to_end = {
        "detect_img_per_s": batch * len(served) / window_s,
        "detect_batch_p95_ms": 1000.0 * nearest_rank(latency, 0.95),
        "setup_s": setup_s,
    }

    ref = RetinaFace(cfg["model"], "eval").to(dev)
    ref.load_state_dict(state)
    ref.eval()
    picks, seen = [], set()
    for c in G.numpy_rng(seed, 4).permutation(len(results)):
        if served[c] not in seen and len(picks) < tr["check_batches"]:
            picks.append(int(c))
            seen.add(served[c])
    comparison, yardstick = RD.Comparison(setting), RD.Comparison(setting)
    for c in sorted(picks):
        if _well_formed(results[c], batch, tr["max_detections"]):
            images = pool[served[c]]
            with reference_precision():
                rows = RD.reference_rows(ref, images, target, priors, variances, dev)
                plain = RD.reference_detect(ref, images, target, priors, variances, setting, dev, "bfloat16")
            comparison.add(results[c], rows)
            yardstick.add(plain, rows)
    q = np.percentile(np.asarray(latency) * 1000.0, [5, 25, 50, 75, 95])
    print("portbench: window calls %d, ms a call at 5/25/50/75/95%%: %s"
          % (len(latency), " ".join(f"{v:.2f}" for v in q)), file=sys.stderr)
    print(f"portbench: the reference's candidates above the confidence: "
          f"{comparison.diagnostics()['candidates_per_image']:.1f} an image of {priors.shape[0]} priors",
          file=sys.stderr)
    ctx = None
    if trace:
        ctx = Context(window.trace, served, pool, cell, ref, priors, setting, dev)
        device_info = {**device_info, "busy_s": window.trace.busy_s, "window_s": window.trace.window_s}
    return Outcome(attempted=len(served), failed=failed, end_to_end=end_to_end,
                   readings=RD.readings(RD.ratios(comparison, yardstick)), device=device_info, ctx=ctx,
                   extra={"raw": comparison.raw(), "yardstick": yardstick.raw(), **comparison.diagnostics()})


def _well_formed(out, batch: int, max_det: int) -> bool:
    return (len(out) == batch and all(
        d.ndim == 2 and d.shape[1] == 15 and d.shape[0] <= max_det and np.isfinite(d).all() for d in out))
