#!/usr/bin/env python3
"""Smoke test of the PyTorch port (jabd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on a mismatch:

0. Card: prints `nvidia-smi --query-gpu=name,power.limit` and builds the
   CUDA kernels from csrc/ (one nvcc per source, all at once).
1. NMS kernels (K1) against their plain version: ops/nms.py on the same
   inputs on the card, B = 8, K = 5000 and 4999, IoU and DIoU, thresholds
   0.3 and 0.45, n_valid 0 / 1 / 37 / K, duplicate boxes, zero-area boxes
   and grid-aligned boxes (exactly tied metrics); then valid rows that are
   not a prefix, DIoU at threshold -0.1, K = 64 and 65, and images at the
   wrapper's largest K. Keep masks must be identical.
2. Serving: jabd_flagship at full width, 640x640, random weights from a
   seeded torch.Generator (random BatchNorm state, NLM output projection
   non-zero), confidence 0.02. With every launch count set to 0 it runs
   Predictor.detect_preprocessed (float32 with TF32 off, and bfloat16 as
   the preset says) on a batch of 8, detect_image on 3 images and a
   BatchingDetector(batch_size=4) answering 8 requests from 4 threads;
   each path must launch K1. Then it checks that the plain NMS gives
   identical detections on the same head outputs, that the float32 heads
   on the card match the port on the CPU, times the paths and breaks one
   bf16 batch down by kernel with torch.profiler.
3. K1's time on the main path's candidates, and its bound; then its time
   with the valid rows cut to a prefix of 50, 500 and 5000.
4. Matching kernel (K2) against its plain version (ops/matching.py) at
   the training shape, B 34, G 128, P 29,126 (840x840): GT counts spread
   over 0..128 per image, then GTs that are prior boxes (exact ties),
   duplicate GTs, valid rows that are not a prefix and GT pairs that
   share a best prior, then GTs whose edge lies exactly on a prior tile's
   bounding box (K2's culling boundary), GTs covering the whole image and
   images whose only valid row is not row 0. Outputs must be
   bit-identical, and so must the MatchResult built on them.
5. Training (`[train]`): jabd_flagship at 840x840 from the reference's
   seeded init, seeded synthetic images and targets. Each path runs with
   every launch count set to 0 and must launch K2: (a) one float32 step
   (TF32 off) at batch 2 on the card against the same step on the CPU:
   loss and its three terms within 1e-3; (b) ten bfloat16 steps at batch
   34 on one batch: the loss finite and lower at the end; (c) `fit` over
   two epochs (batch 34) across the freeze boundary, then resumed from its
   checkpoint for a third: checkpoints, metrics.csv rows. Then train-step
   times and peak memory, a profiler breakdown of bf16 steps, and K2's
   time and bound on the batch-34 targets.
6. Training input (`[augment]`): an in-memory WiderFaceDataset of 68
   seeded uint8 images at WIDER FACE's geometry (`wider_in_memory`: 1024
   px wide, faces with landmarks and +-1 flags). Host img/s per core of
   `augment_sample` and `plan_sample`; at bucket 1024x1024 on the card
   `device_augment` bf16 against f32 and against the host frames (the CPU
   tests' bounds), and its ms per batch of 34. Each path runs with every
   launch count set to 0 and must launch K2: `fit` for two epochs with
   `device_augment=True` and for one on the host loader (checkpoints,
   finite losses), then bf16 bs-34 steps with `remat=True`, with
   `microbatches=2` and with `device_augment=True`, each against the plain
   step (ms/step, peak memory); steps, and `fit` epochs of 8 steps, fed
   through `prefetch_to_device` against copies on the compute stream, in
   turns; a profile of the device-augment step, and K2 against its plain
   version on the augmented batch's targets (bit-identical; time, bound).
7. The rest of inference (`[wider]`), each path with every launch count
   set to 0 and launching K1: (a) the trained golden fixture
   (tests/fixtures/golden_e2e, retinaface_mnet025 at float32, 96x96): its
   three PNGs, decoded by `read_png`, through `run_wider_val` from memory;
   detection counts exact, boxes within 2e-2 px, scores within 1e-3 and the
   evaluator's three APs (over .mat files written with scipy) within 5e-3
   of golden.npz. (b) jabd_flagship bf16 at 1280x1280, confidence 0.02,
   batch 32, over 64 seeded images at WIDER FACE's geometry
   (`wider_in_memory`, as BGR; their faces the ground truth): the sweep in
   its three modes (single scale, host pyramid, device pyramid), each with
   img/s over the sweep, APs finite in [0, 1] and a profiled chunk (device
   busy, host share); K1 against the plain keep masks on one sweep batch
   (B 32, K 5000), its time, bound and mask scratch. (c) the device
   letterbox (float32 and bfloat16) and the device pyramid (float32)
   against the host recipes. (d) `detect_images` on mixed sizes, its
   identity-size image against `detect_image` (within 2e-3 px) on the
   golden model, and on the flagship; `nms_cuda.nms` against the plain
   `nms` at N 5000 and 12,288 (identical), and its raise at N 12,289.
8. The other 14 presets (`[presets]`): random weights from a seeded
   torch.Generator with every BatchNorm's statistics set from its own
   input (`calibrate_batchnorms`), so activations stay O(1) at ResNet-152's
   depth. (a) For each preset float32 heads (TF32 off) at 320x320, bs 2,
   on the card against the port on the CPU, within 1e-3 * max(1, max|ref|)
   per head, and bfloat16 heads finite. (b) Each preset's bf16
   `Predictor.detect_preprocessed` at 640x640, bs 8, confidence 0.02 (5,000
   valid candidates an image), each with every launch count set to 0 and
   launching K1; re50_iou_head's Predictor must raise; K1 identical to the
   plain NMS on re50_eca_nonlocal's candidates; back-to-back ms/batch of
   four presets and a profile of two. (c) K2 against the plain version at
   re152_4level's 117,326 priors (840x840), B 34, G 128, on the cases of
   phase 4, bit-identical; its time and bound. (d) bf16 train steps at
   840x840: re50_eca_nonlocal at bs 34, re152_4level with remat at the
   largest of bs 34 / 17 / 8 that fits: loss finite and lower over 5
   steps on one batch, ms/step, peak memory, a profile, K2 launched; a
   re50_dropout step whose tap dropout drops 0.5 +- 0.01 of the live
   values and doubles the rest.
9. The app surface (`[app]`), each path with every launch count set to 0
   and launching its kernel, the subcommands run in this process through
   `cli.main` (and one as `python3 -m jabd_tpu_torch.cli` in a
   subprocess): (a) the trained golden fixture saved under the reference's
   `.pth` names, `cli map-txt` (batch 3) and `cli eval` on its PNGs, the
   dumps against an in-process `run_wider_val` at the PredictConfig the CLI
   builds, and `cli predict` of a seeded flagship `.pth` at 640x640 against
   `detect_image`; (c) `cli export` of the bf16 flagship (batch 8,
   640x640) loaded in a fresh interpreter that imports `aot.py` only: no
   model code imported, K1 launched, valid masks equal to the live
   Predictor's; (b) the HTTP daemon (`serve.make_server`, what `cli serve`
   starts) over the float32 flagship (TF32 off), 16 concurrent JPEG POSTs
   against `detect_image`, `/healthz` counts, K1 per batch, and one request
   to a daemon over the artifact; (d) `quantize_int8` of the bf16 flagship
   on 8 seeded frames: at every quantized site the int32 conv of the card's
   `_int_mm` route bit-equal to the float64 plain version, heads within
   the JAX package's bounds of bf16 (cls mean < 0.02, box mean < 0.05),
   times against bf16, and the int8 artifact equal to live int8; (e)
   `cli train` (bs 34, 840x840, one epoch over 34 PNGs with a label.txt):
   its checkpoint and metrics.csv, K2 launched, then `cli predict` from
   the checkpoint directory; (f) `cli count --per-layer` (params equal to
   the CPU model's, rows summing to the total) and `cli fps` by both
   methods.
10. The recognition half (`[recognition]`), each path that detects with
   every launch count set to 0 and launching K1: (a) the golden fixture
   (tests/fixtures/golden_recognition): its scenes decoded by `read_png`
   and aligned by the port, byte-equal to the golden crops; ir_18 at
   float32 (TF32 off) from the port's copy of the fixture's path-keyed
   filler (`golden_ir_state_dict`), embeddings and cosine within 1e-4 of
   golden.npz, with the float64 CPU forward beside them. (b) All 12 IR
   names at full width from seeded weights with BatchNorm statistics set
   from their own inputs (`seeded_ir_model`): folded bf16 embeddings at
   112x112, bs 2, finite and unit-norm; ir_101 and ir_50 at float32 on the
   card against the port on the CPU (max abs error <= 1e-4, 1 - cosine <=
   1e-6). (c) `extract_embeddings_tta` of ir_101 with flip TTA, bs 256,
   float32 and bf16, over 2,048 seeded crops: img/s, a profile (device
   busy, idle share, top kernels). (d) `FacePipeline.analyze` with the
   bf16 flagship at 640x640, confidence 0.02, and folded bf16 ir_101
   (embed_batch 16) on 4 images at WIDER FACE's geometry: K1 launched,
   crops warped and normalized on the card byte-equal to the CPU's,
   embeddings equal to `embed_crops` of the host-aligned crops, ms per
   image for detect / align / embed, the CPU warp and cv2.warpAffine
   (the JAX package's warp, timed as a reference the port never calls)
   on the same matrices; a Gallery's matches and npz round trip. (e) `POST /identify` (float32 flagship, TF32 off, confidence 0.5,
   folded ir_50): 8 concurrent JPEG POSTs against the in-process
   `IdentityService.analyze` (detections within 5e-3 px, embeddings within
   1e-5), K1 per batch, /healthz counts, and 503 without an embedder. (f)
   `cli identify` over a PIL-written gallery tree, then from its npz;
   `recognition.cli export` of folded ir_50 (bs 256) loaded in a fresh
   interpreter that imports aot.py only, equal to the live model;
   `--embed-quantize int8` (every int8 site's `_int_mm` int32 output
   bit-equal to the float64 plain version, `fc` included; cosine to the
   folded float32 model > 0.98; bf16 and int8 times) and `cli identify`
   with it; `recognition.cli verify` over a seeded lfw.bin of 600 pairs of
   PIL-written JPEGs, `tinyface`, `extract --partitions 4` and `ijbs` over
   seeded synthetic trees.
11. One JSON line of every kernel of the port: launches on the main paths,
   error against the plain version, times and bound.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Float operations per (kept box i, later valid box j) metric evaluation.
METRIC_FLOPS = {"iou": 14, "diou": 34}
# Float operations per (valid GT, prior) IoU of the matching kernel: 2 min,
# 2 max, 2 subtractions and 2 clamps for the overlap, 1 multiply, 1 add,
# 1 subtraction, 1 division, 1 compare.
MATCH_FLOPS = 13
# Float operations per (valid GT, prior tile) of its culling test: 2 min,
# 2 max, 2 subtractions, 2 compares.
CULL_FLOPS = 8


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per `fn()` with `iters` calls enqueued back to back
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, iters: int = 10) -> dict:
    """Milliseconds of device time per `fn()` by kernel name: the self time
    of every CUDA kernel it launches, under torch.profiler, over `iters`
    calls. Unlike cuda_ms it leaves out the host's time to enqueue them.
    Empty when the profiler saw no kernel in two tries (not measured)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {e.key: e.self_device_time_total / iters / 1000
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if split:
            return split
    return {}


def device_ms(fn, iters: int = 10):
    """The sum of device_split(fn): device milliseconds per call, or None
    when not measured."""
    split = device_split(fn, iters)
    return sum(split.values()) if split else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def print_ptxas(name: str, log: str) -> None:
    """The registers, shared memory and spills lines of an nvcc -Xptxas -v log."""
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build {name}] {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 1 inputs
# ---------------------------------------------------------------------------


def _random_boxes(rng, n, lo=0.0, hi=1.0):
    cxy = rng.uniform(lo + 0.05, hi - 0.05, (n, 2))
    wh = rng.uniform(0.01, 0.2, (n, 2)) * (hi - lo)
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)


def nms_cases(k: int, seed: int):
    """[8, k, 4] boxes and [8, k] valid: the edge cases, one per image."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([_random_boxes(rng, k) for _ in range(8)])
    n_valid = [0, 1, 37, k, k, k, k, 37]
    # 4: duplicates, 50 distinct boxes repeated (identical boxes suppress).
    boxes[4] = _random_boxes(rng, 50)[rng.integers(0, 50, k)]
    # 5: zero-area boxes (x2 == x1) among ordinary ones; union can be 0.
    flat = rng.random(k) < 0.5
    boxes[5, flat, 2] = boxes[5, flat, 0]
    boxes[5, : k // 10] = boxes[5, 0]
    # 6: grid-aligned 10x10 boxes: many exactly equal metrics.
    xy = rng.integers(0, 60, (k, 2)).astype(np.float32)
    boxes[6] = np.concatenate([xy, xy + 10.0], 1)
    # 7: every box the same: all but the first suppressed.
    boxes[7] = boxes[7, :1]
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def nms_phase(dev, max_k: int) -> float:
    """K1 against the plain NMS on the card (module docstring, phase 1).
    Returns the largest |kernel - plain| over the keep masks."""
    from jabd_tpu_torch.ops import nms as N
    from jabd_tpu_torch.ops import nms_cuda

    cases = []
    for k in (5000, 4999):
        boxes, valid = nms_cases(k, seed=k)
        for kind in ("iou", "diou"):
            for thr in (0.3, 0.45):
                cases.append((f"K={k} {kind} thr={thr}", boxes, valid, thr, kind))
    boxes, valid = nms_cases(5000, seed=1)
    scattered = torch.from_numpy(np.random.default_rng(1).random(tuple(valid.shape)) < 0.6)
    for kind in ("iou", "diou"):
        cases.append((f"K=5000 {kind} thr=0.3 valid not a prefix", boxes, scattered, 0.3, kind))
    cases.append(("K=5000 diou thr=-0.1", boxes, valid, -0.1, "diou"))
    for k in (64, 65):
        small, small_valid = nms_cases(k, seed=k)
        for kind in ("iou", "diou"):
            cases.append((f"K={k} {kind} thr=0.3", small, small_valid, 0.3, kind))
    large, large_valid = nms_cases(max_k, seed=max_k)  # images 3 (random) and 6 (ties), all valid
    cases.append((f"K={max_k} (the largest) iou thr=0.3", large[[3, 6]], large_valid[[3, 6]], 0.3, "iou"))
    worst = 0.0
    for name, boxes, valid, thr, kind in cases:
        boxes, valid = boxes.to(dev).contiguous(), valid.to(dev).contiguous()
        got = nms_cuda.nms_keep_sorted(boxes, valid, thr, kind)
        want = N.nms_keep_sorted(boxes, valid, thr, kind)
        torch.cuda.synchronize()
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        print(f"[phase1] {name}: valid/image {valid.sum(1).tolist()} kept/image "
              f"{want.sum(1).tolist()} mismatches {int((got != want).sum())}")
        check(torch.equal(got, want), f"kernel == plain at {name}")
    return worst


def nms_ops(valid, keep_plain, kind):
    """Float operations this data needs: one metric per (kept i, later
    valid j) among each image's valid candidates."""
    n_valid = valid.sum(1)
    pairs = 0
    for b in range(valid.shape[0]):
        kept = torch.nonzero(keep_plain[b, : n_valid[b]]).flatten()
        pairs += int((n_valid[b] - 1 - kept).sum())
    return pairs * METRIC_FLOPS[kind]


def match_ops(truths, valid, priors, tile: int) -> int:
    """Float operations this data needs for K2's function: MATCH_FLOPS per
    (valid GT, prior) pair in a tile of `tile` priors whose bounding box the
    GT meets, CULL_FLOPS per (valid GT, tile). Every other pair's IoU is +0,
    known without computing it."""
    p = priors.shape[0]
    ntiles = -(-p // tile)
    corners = torch.cat([priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], 1)
    pad = torch.tensor([[np.inf, np.inf, -np.inf, -np.inf]], device=priors.device).expand(ntiles * tile - p, 4)
    corners = torch.cat([corners, pad]).view(ntiles, tile, 4)
    lo, hi = corners[..., :2].amin(1), corners[..., 2:].amax(1)  # [T, 2] each
    t = truths[:, :, None, :]  # [B, G, 1, 4]
    meets = ((torch.minimum(t[..., 2:], hi) - torch.maximum(t[..., :2], lo)) > 0).all(-1)
    meets &= valid[:, :, None]
    sizes = torch.full((ntiles,), tile, device=priors.device)
    sizes[-1] = p - (ntiles - 1) * tile
    pairs = int((meets * sizes).sum())
    return MATCH_FLOPS * pairs + CULL_FLOPS * int(valid.sum()) * ntiles


# ---------------------------------------------------------------------------
# Phase 2 weights
# ---------------------------------------------------------------------------


def calibrate_batchnorms(model, images) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    its own input, in one eval forward of `images`: each then normalizes
    what reaches it. Random statistics would compound over ResNet-152's 50
    residual blocks (each relu(out + skip) about doubles the variance) and
    saturate the heads. BatchNorms over 1x1 maps (the SE modules') keep
    theirs: a few images' pooled features vary too little between images
    to estimate a variance, and other images would then saturate them."""
    def take(m, args):
        x = args[0].float()
        if x.shape[2] * x.shape[3] > 1:
            m.running_mean.copy_(x.mean((0, 2, 3)))
            m.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model.eval()(images)
    for h in hooks:
        h.remove()


def seeded_state_dict(cfg, seed: int, calibrate=None):
    """Random weights for `cfg` from a seeded torch.Generator: conv weights
    N(0, 1/fan_in) (the head convs 0.1 times that), biases N(0, 0.1^2),
    BatchNorm scale 1 + N(0, 0.1^2), shift and running mean N(0, 0.1^2),
    running var U(0.5, 1.5). An NLM's output projection, zero at init,
    becomes non-zero. With `calibrate` (NCHW images on a device) the
    running statistics are then set by `calibrate_batchnorms` there."""
    from jabd_tpu_torch.models import build_model

    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, mode="eval", device="cpu")
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
                std = m.weight[0].numel() ** -0.5
                if name.endswith("conv1x1"):  # heads: deltas of a few units
                    std *= 0.1
                m.weight.copy_(std * torch.randn(m.weight.shape, generator=g))
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    if model.fpn.nlm is not None:
        check(bool(model.fpn.nlm.W.weight.abs().sum() > 0), "NLM W is non-zero")
    if calibrate is not None:
        calibrate_batchnorms(model.to(calibrate.device), calibrate)
    return {k: v.cpu() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# Phase 4 and 5 inputs
# ---------------------------------------------------------------------------


def face_rows(rng, counts):
    """One [n, 15] target per count: corner boxes in [0, 1] (sides 0.02 to
    0.3), five landmarks inside each, label 1 (80%) or -1."""
    out = []
    for n in counts:
        boxes = np.clip(_random_boxes(rng, int(n)), 0.0, 1.0)
        rows = np.zeros((int(n), 15), np.float32)
        rows[:, :4] = boxes
        u = rng.uniform(0.2, 0.8, (int(n), 5, 2))
        rows[:, 4:14] = (boxes[:, None, :2] + u * (boxes[:, None, 2:] - boxes[:, None, :2])).reshape(-1, 10)
        rows[:, 14] = np.where(rng.random(int(n)) < 0.8, 1.0, -1.0)
        out.append(rows)
    return out


def spread_counts(b, g):
    """GT counts spread over 0..g: the first image full, the last empty."""
    return np.linspace(g, 0, b).round().astype(int)


def tie_targets(rng, priors, b, g):
    """A batch of exact-tie cases, one kind per image in turn: GTs that are
    prior boxes (IoU exactly 1, and equal IoUs with equally placed
    neighbours), 16 distinct GTs repeated over all rows, valid rows that
    are not a prefix, and GT pairs that share a best prior (each odd row
    the even row before it, shifted by 0.003)."""
    from jabd_tpu_torch.data.wider import batch_targets

    boxes, labels, landms, valid = batch_targets(face_rows(rng, [g] * b), g)
    corners = np.concatenate([priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], 1)
    for i in range(b):
        kind = i % 4
        if kind == 0:
            boxes[i] = corners[rng.choice(len(priors), g, replace=False)]
        elif kind == 1:
            boxes[i] = boxes[i, rng.integers(0, 16, g)]
        elif kind == 2:
            valid[i] = rng.random(g) < 0.4
        else:
            boxes[i, 1::2] = boxes[i, 0::2] + np.float32(0.003)
    return boxes, labels, landms, valid


def edge_targets(rng, priors, b, g):
    """K2's culling boundaries, one kind per image in turn: GTs whose edge
    lies exactly on an edge of a 1024-prior tile's bounding box (touching
    it from each side) and ones a float step inside it, over every tile in
    turn; GTs covering the whole image among ordinary faces; a single valid
    row that is not row 0."""
    from jabd_tpu_torch.data.wider import batch_targets

    boxes, labels, landms, valid = batch_targets(face_rows(rng, [g] * b), g)
    # The kernel's corner arithmetic, in float32.
    corners = np.concatenate([priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], 1)
    w = h = np.float32(0.05)
    edges = []
    for lo in range(0, len(priors), 1024):
        x1, y1 = corners[lo : lo + 1024, :2].min(0)
        x2, y2 = corners[lo : lo + 1024, 2:].max(0)
        x, y = rng.uniform(0.2, 0.7, 2).astype(np.float32)
        edges += [
            [x, y2, x + w, y2 + h], [x, y1 - h, x + w, y1],
            [x2, y, x2 + w, y + h], [x1 - w, y, x1, y + h],
            [x, np.nextafter(y2, np.float32(-2)), x + w, y2 + h],
            [np.nextafter(x2, np.float32(-2)), y, x2 + w, y + h],
        ]
    edges = np.asarray(edges, np.float32)
    for i in range(b):
        kind = i % 3
        if kind == 0:
            boxes[i] = np.roll(edges, -(i // 3) * g, axis=0)[np.arange(g) % len(edges)]
            valid[i] = True
        elif kind == 1:
            boxes[i, ::7] = [0.0, 0.0, 1.0, 1.0]
        else:
            valid[i] = False
            valid[i, 1 + i % (g - 1)] = True
    return boxes, labels, landms, valid


class SyntheticFaces:
    """In-memory training set for `train.fit`: `get(idx, rng)` draws a
    noise image (as the front end leaves it: mean-subtracted float32 HWC,
    std 50) and 1..40 face rows from the sample's stream."""

    def __init__(self, n: int, size: int):
        self.n = n
        self.size = size

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        image = rng.normal(0, 50, (self.size, self.size, 3)).astype(np.float32)
        return image, face_rows(rng, [1 + idx % 40])[0]


def to_targets(arrays, dev):
    from jabd_tpu_torch.losses import Targets

    return Targets(*(torch.from_numpy(a).to(dev) for a in arrays))


def reset_counts():
    from jabd_tpu_torch.ops import matching_cuda, nms_cuda

    nms_cuda.nms_keep_sorted.launches = 0
    matching_cuda.match_front.launches = 0


def matching_phase(dev, priors_np, tag: str = "[phase4]"):
    """K2 against the plain front half on the card at B 34, G 128 and the
    840x840 priors `priors_np`. Returns the largest |kernel - plain| over
    all outputs."""
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.ops import matching as M
    from jabd_tpu_torch.ops import matching_cuda

    rng = np.random.default_rng(4)
    b, g = 34, 128
    priors = torch.from_numpy(priors_np).to(dev)
    cases = [
        ("spread 0..128", batch_targets(face_rows(rng, spread_counts(b, g)), g)),
        ("ties", tie_targets(rng, priors_np, b, g)),
        ("tile edges, whole image, single row", edge_targets(rng, priors_np, b, g)),
    ]
    worst = 0.0
    for name, arrays in cases:
        t = to_targets(arrays, dev)
        got = matching_cuda.match_front(t.boxes, priors, t.valid)
        want = M.match_front_plain(t.boxes, priors, t.valid)
        torch.cuda.synchronize()
        mism = [int((x != y).sum()) for x, y in zip(got, want)]
        bits = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want))
        worst = max(worst, err)
        args = (0.35, t.boxes, priors, (0.1, 0.2), t.labels, t.landms, t.valid)
        r_k = M.match_batch(*args, front=matching_cuda.match_front)
        r_p = M.match_batch(*args, front=M.match_front_plain)
        same = all(torch.equal(x, y) for x, y in zip(r_k, r_p))
        counts = t.valid.sum(1)
        print(f"{tag} K2 {name}: B={b} G={g} P={priors.shape[0]}, valid GTs per image "
              f"min {int(counts.min())} max {int(counts.max())} total {int(counts.sum())}; "
              f"mismatches (overlap, idx, best prior) {mism}, overlaps bit-identical {bits}, "
              f"MatchResult identical {same}, positives {int((r_k.conf_t != 0).sum())}")
        check(mism == [0, 0, 0] and bits and same, f"K2 == plain on {name}")
    return worst


def train_phase(card, dev, preset):
    """Drive the training path (see the module docstring, phase 5) and
    return K2's kernels-line numbers."""
    import dataclasses
    import os
    import tempfile

    from jabd_tpu_torch import configs
    from jabd_tpu_torch import train as T
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import matching as M
    from jabd_tpu_torch.ops import matching_cuda
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    counter = matching_cuda.match_front
    tcfg = configs.TrainConfig()
    size, bsz, g = tcfg.image_size, tcfg.batch_size, tcfg.max_targets
    anchors_np = A.generate_anchors(preset.anchors, (size, size)).copy()
    anchors = torch.from_numpy(anchors_np).to(dev)
    cfg32 = dataclasses.replace(preset, compute_dtype="float32")
    rng = np.random.default_rng(5)
    launches = {}

    def driven(name, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = counter.launches
        check(counter.launches > 0, f"{name} launched K2")
        return out

    # (a) float32, batch 2: the card against the CPU from the same weights.
    images2 = rng.normal(0, 50, (2, size, size, 3)).astype(np.float32)
    targets2 = batch_targets(face_rows(rng, [37, 5]), g)
    s_gpu = T.create_train_state(cfg32, tcfg, 1, freeze_backbone=False, device=dev)
    s_cpu = T.create_train_state(cfg32, tcfg, 1, freeze_backbone=False, device="cpu")
    cpu_sd = s_cpu.model.state_dict()
    check(all(torch.equal(v.cpu(), cpu_sd[k]) for k, v in s_gpu.model.state_dict().items()),
          "card and CPU start from the same seeded weights")
    step32 = T.make_train_step(cfg32, tcfg)
    _, m_gpu = driven("train_step f32 bs2", lambda: step32(
        s_gpu, torch.from_numpy(images2).to(dev), to_targets(targets2, dev), anchors))
    t0 = time.perf_counter()
    _, m_cpu = step32(s_cpu, torch.from_numpy(images2), to_targets(targets2, "cpu"),
                      torch.from_numpy(anchors_np))
    cpu_s = time.perf_counter() - t0
    for k in ("loss", "loss_l", "loss_c", "loss_landm"):
        got, want = float(m_gpu[k]), float(m_cpu[k])
        rel = abs(got - want) / max(abs(want), 1e-12)
        print(f"[train] (a) f32 bs2 {k}: card {got:.7f} CPU {want:.7f} rel err {rel:.3e}")
        check(np.isfinite(got) and rel <= 1e-3, f"{k} card f32 matches CPU f32 within 1e-3")
    print(f"[train] (a) the CPU step took {cpu_s:.1f} s")
    del s_gpu, s_cpu

    # (b) bfloat16 (the preset), batch 34, ten steps on one batch.
    images34 = torch.from_numpy(rng.normal(0, 50, (bsz, size, size, 3)).astype(np.float32)).to(dev)
    arrays34 = batch_targets(face_rows(rng, np.maximum(spread_counts(bsz, g), 1)), g)
    targets34 = to_targets(arrays34, dev)
    s16 = T.create_train_state(preset, tcfg, 1, freeze_backbone=False, device=dev)
    step16 = T.make_train_step(preset, tcfg)
    losses16 = driven("train_step bf16 bs34 x10", lambda: [
        step16(s16, images34, targets34, anchors)[1]["loss"] for _ in range(10)])
    vals = [float(v) for v in losses16]
    print(f"[train] (b) bf16 bs34 losses over 10 steps {[round(v, 4) for v in vals]}")
    check(all(np.isfinite(vals)) and vals[-1] < vals[0], "bf16 loss finite and lower after 10 steps")

    # (c) fit: two epochs across the freeze boundary, then resumed.
    with tempfile.TemporaryDirectory() as tmp:
        ds = SyntheticFaces(bsz, size)
        fcfg = dataclasses.replace(tcfg, freeze_epochs=1, total_epochs=2, save_period=1)
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        log_dir = os.path.join(tmp, "logs")
        st = driven("fit 2 epochs", lambda: T.fit(preset, fcfg, ds, log_dir=log_dir,
                                                  checkpoint_manager=mgr, device=dev))
        check(mgr.latest_step() == 2 and st.step == 2, "fit: checkpoints 1 and 2, 2 steps")
        st = driven("fit resumed to epoch 3", lambda: T.fit(
            preset, dataclasses.replace(fcfg, total_epochs=3), ds, log_dir=log_dir,
            checkpoint_manager=mgr, device=dev))
        rows = open(os.path.join(log_dir, "metrics.csv")).read().splitlines()
        print(f"[train] (c) fit checkpoints {mgr.all_steps()}, step {st.step}, metrics.csv {rows[1:]}")
        check(mgr.latest_step() == 3 and st.step == 3 and len(rows) == 4, "fit resumed: epoch 3")
        check(all(np.isfinite(float(r.split(",")[2])) for r in rows[1:]), "fit losses finite")
        del st
    print(f"[train] K2 launches per path {launches}")
    torch.cuda.empty_cache()

    # Train-step time and peak memory, batch 34, back to back.
    s32 = T.create_train_state(cfg32, tcfg, 1, freeze_backbone=False, device=dev)
    for tag, state, step in (("bf16", s16, step16), ("f32", s32, step32)):
        torch.cuda.reset_peak_memory_stats()
        ms = back_to_back_ms(lambda: step(state, images34, targets34, anchors), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[time] train step {tag} bs{bsz} {size}x{size}: back-to-back {ms:.3f} ms/step "
              f"({1000 * bsz / ms:.1f} img/s), peak memory {peak:.2f} GiB [{card}]")
    del s32
    torch.cuda.empty_cache()

    # Where the time of a bf16 step goes: device time by kernel over 3 steps.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    step16(s16, images34, targets34, anchors)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step16(s16, images34, targets34, anchors)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / 3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1000 / 3
    print(f"[profile] train step bf16 bs{bsz} under the profiler: wall {wall_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in rows) / 3:.0f} kernels/step [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile]   {e.self_device_time_total / 1000 / 3:8.3f} ms/step "
              f"{e.count // 3:5d}x {e.key[:90]}")

    # K2 on the batch-34 targets: time, plain time, bound.
    boxes, valid = targets34.boxes, targets34.valid
    ms = cuda_ms(lambda: matching_cuda.match_front(boxes, anchors, valid), iters=50)
    dev_ms = device_ms(lambda: matching_cuda.match_front(boxes, anchors, valid))
    plain_ms = cuda_ms(lambda: M.match_front_plain(boxes, anchors, valid), iters=10)
    got = matching_cuda.match_front(boxes, anchors, valid)
    want = M.match_front_plain(boxes, anchors, valid)
    err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want))
    check(err == 0.0, "K2 == plain on the training batch's targets")
    p = anchors.shape[0]
    nbytes = (boxes.numel() * 4 + valid.numel() + anchors.numel() * 4  # in
              + bsz * p * (4 + 8) + bsz * g * 8)  # out: overlap f32, idx and best prior int64
    n_valid = int(valid.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = match_ops(boxes, valid, anchors, matching_cuda._library().jabd_match_tile()) / F32_FLOPS * 1e3
    dense_ms = MATCH_FLOPS * n_valid * p / F32_FLOPS * 1e3
    print(f"[train] K2 match_front B={bsz} G={g} P={p}, {n_valid} valid GTs: kernel {ms:.4f} ms "
          f"(device {fmt_ms(dev_ms)}), "
          f"plain {plain_ms:.4f} ms, bytes bound {bytes_ms:.6f} ms, operations bound "
          f"{ops_ms:.6f} ms (dense count, every pair: {dense_ms:.6f} ms) [{card}]")
    return {
        "launches": sum(launches.values()),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG as `cv2.imread` gives it (uint8
    [H, W, 3], BGR), with zlib and numpy only: the card's machine has
    neither cv2 nor PIL. Undoes the five scanline filters (PNG spec 9)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    check((depth, color, interlace) == (8, 2, 0), f"{path}: 8-bit RGB, not interlaced")
    bpp, stride = 3, 3 * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype in (0, 2):  # None; Up
            cur = (line + (prev if ftype == 2 else 0)) & 0xFF
        else:  # Sub, Average, Paeth: each byte needs its decoded left neighbour
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return np.ascontiguousarray(out.reshape(h, w, 3)[:, :, ::-1])


def golden_ir_state_dict(arch: str = "ir_18"):
    """The port's copy of the path-keyed filler of
    scripts/make_recognition_golden.py::deterministic_variables: each flax
    leaf from a numpy Generator seeded by the crc32 of its `keystr` path
    ("['params']['stage1_block0']['conv1']['kernel']"): kernels fan-in
    normal in the flax layout, BatchNorm scale 1 / bias 0 / mean 0 / var 1,
    PReLU alpha 0.25, biases 0. Returns the port's state dict."""
    import zlib

    from jabd_tpu_torch.recognition import build_model
    from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax

    template = flax_from_state_dict(build_model(arch, device="cpu").state_dict())

    def fill(tree, path):
        out = {}
        for key, leaf in tree.items():
            p = path + (key,)
            if isinstance(leaf, dict):
                out[key] = fill(leaf, p)
                continue
            name = "".join(f"['{k}']" for k in p)
            shape = leaf.shape
            if p[0] == "batch_stats":
                v = np.zeros(shape) if key == "mean" else np.ones(shape)
            elif key == "scale":
                v = np.ones(shape)
            elif key == "bias":
                v = np.zeros(shape)
            elif key == "alpha":
                v = np.full(shape, 0.25)
            else:
                fan_in = int(np.prod(shape[:-1])) or 1
                v = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(shape) / np.sqrt(fan_in)
            out[key] = v.astype(np.float32)
        return out

    return state_dict_from_flax(fill(template, ()))


def smooth_image(rng, h: int, w: int) -> np.ndarray:
    """A uint8 [h, w, 3] image of smooth seeded content: noise on a grid
    16 times coarser, bilinearly upsampled, plus fine noise."""
    import torch.nn.functional as F

    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 16 + 2, w // 16 + 2)).astype(np.float32))
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    x = x.numpy() + rng.normal(0, 4, (h, w, 3)).astype(np.float32)
    return np.clip(x, 0, 255).astype(np.uint8)


# WIDER FACE's geometry (Yang et al., "WIDER FACE: A Face Detection
# Benchmark", CVPR 2016): the released images are 1024 px wide; 393,703
# faces in 32,203 images, 12.2 per image on average; the paper's scale
# classes are face heights of 10-50 px (small), 50-300 (medium) and over
# 300 (large). What the paper does not give is drawn here by assumption:
# the image heights (the aspect ratios of WIDER_ASPECTS), a geometric count
# of faces per image, face heights log-uniform over 10-500 px (41% small,
# 46% medium, 13% large) and face widths 0.8-1.0 of the height.
WIDER_WIDTH = 1024
WIDER_FACES_PER_IMAGE = 393_703 / 32_203
WIDER_FACE_PX = (10.0, 500.0)
WIDER_ASPECTS = ((4, 3), (3, 2), (16, 9), (3, 4))  # width : height


def wider_rows(rng, w: int, h: int, n: int) -> np.ndarray:
    """n WIDER-style [x1 y1 x2 y2, 5 x (lx, ly), flag] rows in pixels: face
    heights log-uniform over WIDER_FACE_PX (at most the image's short side),
    landmarks inside the box with flag 1, or -1 everywhere with flag -1 (a
    face without landmarks), as parse_wider_labels gives them."""
    lo, hi = np.log(WIDER_FACE_PX)
    side = np.minimum(np.exp(rng.uniform(lo, hi, n)), min(w, h) - 2)
    bw = side * rng.uniform(0.8, 1.0, n)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - side)
    rows = np.zeros((n, 15), np.float32)
    rows[:, :4] = np.stack([x1, y1, x1 + bw, y1 + side], 1)
    u = rng.uniform(0.2, 0.8, (n, 5, 2))
    rows[:, 4:14] = (rows[:, None, :2] + u * (rows[:, None, 2:4] - rows[:, None, :2])).reshape(n, 10)
    flag = rng.random(n) < 0.7
    rows[~flag, 4:14] = -1.0
    rows[:, 14] = np.where(flag, 1.0, -1.0)
    return rows


def wider_in_memory(n: int, input_size: int, seed: int):
    """A WiderFaceDataset over n seeded in-memory images (no files) at
    WIDER FACE's geometry: WIDER_WIDTH wide, heights from WIDER_ASPECTS,
    a geometric number of faces with mean WIDER_FACES_PER_IMAGE."""
    from jabd_tpu_torch.data.wider import WiderFaceDataset

    class InMemoryWider(WiderFaceDataset):
        def __init__(self):
            rng = np.random.default_rng(seed)
            self.input_size, self.seed = input_size, seed
            self.images, self.annos = [], []
            for _ in range(n):
                aw, ah = WIDER_ASPECTS[int(rng.integers(len(WIDER_ASPECTS)))]
                w, h = WIDER_WIDTH, WIDER_WIDTH * ah // aw
                self.images.append(smooth_image(rng, h, w))
                faces = int(rng.geometric(1.0 / WIDER_FACES_PER_IMAGE))
                self.annos.append(wider_rows(rng, w, h, faces))
            self.imgs_path = [f"in-memory/{i}" for i in range(n)]

        def load_image(self, index):
            return self.images[index]

    return InMemoryWider()


class RepeatedDataset:
    """`times` passes over a WiderFaceDataset as one dataset: index i reads
    image i % n with its own augmentation draw (sample_rng of i)."""

    def __init__(self, ds, times: int):
        self.ds, self.times = ds, times
        self.annos = ds.annos * times
        self.input_size = ds.input_size

    def __len__(self):
        return len(self.ds) * self.times

    def load_image(self, index):
        return self.ds.load_image(index % len(self.ds))

    def get(self, index, rng):
        return self.ds.get(index % len(self.ds), rng)


def copies_on_compute_stream(iterator, device, depth: int = 2):
    """prefetch_to_device's earlier design, for comparison: the same pinned,
    non-blocking copies, issued on the current (compute) stream."""
    from jabd_tpu_torch import train as T

    queue = collections.deque()
    for batch in iterator:
        queue.append(T._to_device(batch, torch.device(device), []))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def fed_step_ms(prefetch, batch, run_step, dev, n: int = 6) -> float:
    """Milliseconds per step (host clock, synchronised at both ends) of n
    steps fed by `prefetch` from n references to one CPU batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for moved in prefetch(iter([batch] * n), dev):
        run_step(moved)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000 / n


def fed_steps(name, cpu_batch, run_step, dev, resident_ms: float, card: str) -> None:
    """Print the ms/step of run_step fed from one CPU batch through
    copies_on_compute_stream (C) and prefetch_to_device (S), 8 steps a
    turn, in turns C S S C C S, beside the step on a batch resident on the
    card; check that the batch arrives intact."""
    from jabd_tpu_torch import train as T

    moved = next(T.prefetch_to_device(iter([cpu_batch]), dev))
    check(torch.equal(moved[0].cpu(), cpu_batch[0]), f"prefetch_to_device {name}: the batch arrives")
    del moved
    feeds = {"compute": copies_on_compute_stream, "side": T.prefetch_to_device}
    for feed in feeds.values():  # warm-up: pinned buffers, allocator
        fed_step_ms(feed, cpu_batch, run_step, dev, n=2)
    turns = {k: [] for k in feeds}
    for k in ("compute", "side", "side", "compute", "compute", "side"):
        turns[k].append(fed_step_ms(feeds[k], cpu_batch, run_step, dev, n=8))
    copy_ms = cuda_ms(lambda: T._to_device(cpu_batch, torch.device(dev), []), iters=5)
    mb = sum(t.numel() * t.element_size() for t in cpu_batch if isinstance(t, torch.Tensor)) / 1e6
    print(f"[augment] fed steps {name} ({mb:.1f} MB a batch; pin + copy alone {copy_ms:.3f} ms events): "
          f"ms/step over 8 steps in turns C S S C C S, copies on the compute stream (C) "
          f"{[round(v, 3) for v in turns['compute']]} median {statistics.median(turns['compute']):.3f}, "
          f"prefetch_to_device (S) {[round(v, 3) for v in turns['side']]} median "
          f"{statistics.median(turns['side']):.3f}; batch resident on the card {resident_ms:.3f} [{card}]")


def pixel_bounds(got: torch.Tensor, want: torch.Tensor):
    """(max, mean, share of pixels with a channel beyond 6) of |got - want|
    per image, the CPU tests' device-vs-host rule (mean <= 0.5, share <=
    0.005): near-grey pixels flip hue under the reference's H > 1 quirk."""
    err = (got.float() - want.float()).abs()
    per_img_mean = err.flatten(1).mean(1)
    share = (err.amax(-1) > 6.0).flatten(1).float().mean(1)
    return float(err.max()), per_img_mean, share


def augment_phase(card, dev, preset):
    """Drive the training-input paths (module docstring, phase 6) and
    return K2's launches and error on them."""
    import dataclasses
    import os
    import tempfile

    from jabd_tpu_torch import configs
    from jabd_tpu_torch import train as T
    from jabd_tpu_torch.data import device_augment as DA
    from jabd_tpu_torch.data.wider import augment_sample, batch_targets, draw_augment_params, sample_rng
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import matching as M
    from jabd_tpu_torch.ops import matching_cuda
    from jabd_tpu_torch.ops.image import preprocess_input_np
    from jabd_tpu_torch.ops.resize import TAPS_FSCAP
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    counter = matching_cuda.match_front
    tcfg = configs.TrainConfig()
    size, bsz, g, bucket = tcfg.image_size, tcfg.batch_size, tcfg.max_targets, tcfg.augment_bucket
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (size, size)).copy()).to(dev)
    launches = {}

    def driven(name, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = counter.launches
        check(counter.launches > 0, f"{name} launched K2")
        return out

    t0 = time.perf_counter()
    ds = wider_in_memory(2 * bsz, size, seed=6)
    heights = [im.shape[0] for im in ds.images]
    faces = [len(a) for a in ds.annos]
    face_h = np.concatenate([a[:, 3] - a[:, 1] for a in ds.annos])
    classes = [int(((face_h >= lo) & (face_h < hi)).sum()) for lo, hi in ((10, 50), (50, 300), (300, 1e9))]
    print(f"[augment] dataset: {len(ds)} images {WIDER_WIDTH} px wide, heights {min(heights)}-{max(heights)} px "
          f"({sum(h > bucket[0] for h in heights)} taller than the bucket), faces per image "
          f"{min(faces)}-{max(faces)} (mean {np.mean(faces):.2f}, {sum(faces)} in all; small / medium / large "
          f"{classes}), made in {time.perf_counter() - t0:.1f} s")

    # Host rates, one thread: what one loader core delivers.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        idx = list(range(bsz))
        t0 = time.perf_counter()
        host = [augment_sample(ds.images[i], ds.annos[i], size, sample_rng(0, i)) for i in idx]
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plans = [DA.plan_sample(ds.images[i], ds.annos[i], size, sample_rng(0, i), bucket) for i in idx]
        plan_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    print(f"[augment] host, one thread, {bsz} images at {size}x{size}: augment_sample "
          f"{bsz / host_s:.2f} img/s per core ({1000 * host_s / bsz:.1f} ms/image); plan_sample "
          f"(bucket {bucket[0]}x{bucket[1]}, taps) {bsz / plan_s:.2f} img/s per core "
          f"({1000 * plan_s / bsz:.1f} ms/image); {os.cpu_count()} cores")
    for (_, hb), (_, _, pb) in zip(host, plans):
        check(np.array_equal(hb, pb), "plan_sample targets == augment_sample targets")

    # device_augment at the bucket on the card: bf16 against f32, against the host.
    u8 = torch.from_numpy(np.stack([p[0] for p in plans])).to(dev)
    plan32 = DA.AugmentPlanTaps(*(t.to(dev) for t in DA.stack_plans([p[1] for p in plans])))
    plan16 = DA.AugmentPlanTaps(*(t.to(dev) for t in DA.stack_plans([p[1] for p in plans], torch.bfloat16)))
    f32 = DA.device_augment(u8, plan32, resample_dtype=torch.float32)
    bf16 = DA.device_augment(u8, plan16)
    host_frames = torch.from_numpy(np.stack([preprocess_input_np(im) for im, _ in host])).to(dev)
    # Sources larger than the bucket, or downscaled by more than TAPS_FSCAP,
    # are pre-shrunk on the host (PIL bicubic) before the device resample:
    # two resamples instead of one, so their pixels differ from the host's
    # by more than rounding; the CPU tests' bounds hold for the others.
    shrunk = []
    for i in idx:
        d = draw_augment_params(sample_rng(0, i), size)
        ih, iw = ds.images[i].shape[:2]
        shrunk.append(ih > min(bucket[0], int(TAPS_FSCAP * max(d.nh, 1)))
                      or iw > min(bucket[1], int(TAPS_FSCAP * max(d.nw, 1))))
    shrunk = torch.tensor(shrunk, device=dev)
    cases = (("bf16 vs f32", bf16, f32, torch.ones_like(shrunk), 0.5, 0.005),
             ("device f32 vs host, sources resampled once", f32, host_frames, ~shrunk, 0.5, 0.005),
             ("device f32 vs host, sources pre-shrunk", f32, host_frames, shrunk, 3.0, 0.25))
    for name, got, want, sel, mean_max, share_max in cases:
        check(bool(torch.isfinite(got).all()), f"{name}: finite")
        if not bool(sel.any()):
            print(f"[augment] device_augment {name}: no such image in the batch")
            continue
        worst, means, share = pixel_bounds(got[sel], want[sel])
        print(f"[augment] device_augment {name}, {int(sel.sum())} of B={bsz}, {size}x{size} from "
              f"{bucket[0]}x{bucket[1]}: max |err| {worst:.3f}, per-image mean max {float(means.max()):.4f} "
              f"(all {float(means.mean()):.4f}), share of pixels beyond 6 max {float(share.max()):.5f} "
              f"(bounds {mean_max}, {share_max})")
        check(float(means.max()) <= mean_max and float(share.max()) <= share_max, f"device_augment {name} within bounds")
    fn = lambda: DA.device_augment(u8, plan16)  # noqa: E731
    aug_ms = cuda_ms(fn, iters=10)
    aug_split = device_split(fn, iters=5)
    s_ = size
    flops = 2 * bsz * s_ * bucket[0] * bucket[1] * 3 + 2 * bsz * s_ * bucket[1] * s_ * 3
    nbytes = u8.numel() + sum(t.numel() * t.element_size() for t in plan16) + bsz * s_ * s_ * 3 * 4
    print(f"[augment] device_augment bf16 B={bsz}: {aug_ms:.3f} ms/batch events, device "
          f"{fmt_ms(sum(aug_split.values()) if aug_split else None)}; the two dense matmuls "
          f"{flops / 1e9:.1f} GFLOP (bf16 peak 989 TFLOP/s: {flops / 989e12 * 1e3:.4f} ms), "
          f"{nbytes / 1e6:.1f} MB in and out ({nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) [{card}]")
    for name, t in sorted(aug_split.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[augment]   device {t:.4f} ms {name[:80]}")
    del f32, bf16, host_frames, host
    torch.cuda.empty_cache()

    # fit through both loaders.
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw, epochs in (("fit device_augment 2 epochs", dict(device_augment=True), 2),
                                 ("fit host loader 1 epoch", dict(), 1)):
            fcfg = dataclasses.replace(tcfg, freeze_epochs=1, total_epochs=epochs, save_period=1, **kw)
            run_dir = os.path.join(tmp, f"run{len(launches)}")
            mgr = CheckpointManager(os.path.join(run_dir, "ckpt"))
            t0 = time.perf_counter()
            st = driven(name, lambda: T.fit(preset, fcfg, ds, log_dir=os.path.join(run_dir, "logs"),
                                            checkpoint_manager=mgr, device=dev))
            secs = time.perf_counter() - t0
            rows = open(os.path.join(run_dir, "logs", "metrics.csv")).read().splitlines()[1:]
            print(f"[augment] {name}: {secs:.1f} s, checkpoints {mgr.all_steps()}, step {st.step}, "
                  f"metrics.csv {rows}")
            check(mgr.all_steps() == list(range(1, epochs + 1)) and st.step == 2 * epochs,
                  f"{name}: a checkpoint per epoch, 2 steps per epoch")
            check(all(np.isfinite([float(v) for v in r.split(",")[2:6]]).all() for r in rows), f"{name}: losses finite")
            del st
    torch.cuda.empty_cache()

    # bf16 steps at batch 34 on the augmented batch: plain, remat,
    # microbatches=2, device_augment, each from the same init.
    frames = DA.device_augment(u8, plan16)
    targets = to_targets(batch_targets([p[2] for p in plans], g), dev)
    n_valid = int(targets.valid.sum())
    variants = [
        ("plain", {}, lambda st, step: step(st, frames, targets, anchors)),
        ("remat", dict(remat=True), lambda st, step: step(st, frames, targets, anchors)),
        ("microbatches=2", dict(microbatches=2), lambda st, step: step(st, frames, targets, anchors)),
        ("device_augment", dict(device_augment=True), lambda st, step: step(st, u8, plan16, targets, anchors)),
    ]
    step_ms = {}
    for name, kw, call in variants:
        vcfg = dataclasses.replace(tcfg, **kw)
        st = T.create_train_state(preset, vcfg, 1, device=dev)
        step = T.make_train_step(preset, vcfg)
        loss = driven(f"train_step bf16 bs{bsz} {name}", lambda: float(call(st, step)[1]["loss"]))
        check(np.isfinite(loss), f"{name} step: loss finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[name] = back_to_back_ms(lambda: call(st, step), iters=8, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_ms(lambda: call(st, step), iters=3)
        print(f"[augment] train step bf16 bs{bsz} {size}x{size} {name}: back-to-back {step_ms[name]:.3f} ms/step "
              f"({1000 * bsz / step_ms[name]:.1f} img/s), device busy {fmt_ms(busy)}/step, peak memory "
              f"{peak:.2f} GiB, first loss {loss:.4f}, {n_valid} valid GTs [{card}]")
        if name in ("plain", "device_augment"):
            # The same steps fed from CPU batches, as fit feeds them.
            cpu_targets = tuple(t.cpu() for t in targets)
            if name == "plain":
                cpu_batch = (frames.cpu(), None, *cpu_targets)
                run = lambda b: step(st, b[0], type(targets)(*b[2:]), anchors)  # noqa: E731
            else:
                cpu_batch = (u8.cpu(), DA.AugmentPlanTaps(*(t.cpu() for t in plan16)), *cpu_targets)
                run = lambda b: step(st, b[0], b[1], type(targets)(*b[2:]), anchors)  # noqa: E731
            fed_steps(f"{name} bf16", cpu_batch, run, dev, step_ms[name], card)
        if name == "device_augment":
            aug_state, aug_step = st, step
        else:
            del st
        torch.cuda.empty_cache()

    # The plain step at float32 from a batch already in pinned memory: its
    # device time exceeds the host's enqueue time, so a copy on the compute
    # stream delays it and one on a side stream should not.
    p32 = dataclasses.replace(preset, compute_dtype="float32")
    st, step = T.create_train_state(p32, tcfg, 1, device=dev), T.make_train_step(p32, tcfg)
    resident = back_to_back_ms(lambda: step(st, frames, targets, anchors), iters=4, warmup=1)
    cpu_batch = (frames.cpu().pin_memory(), None, *(t.cpu().pin_memory() for t in targets))
    fed_steps("plain f32, batch pinned", cpu_batch, lambda b: step(st, b[0], type(targets)(*b[2:]), anchors),
              dev, resident, card)
    del st, step, cpu_batch
    torch.cuda.empty_cache()

    # fit's epoch on the device loader, 8 steps (the 68 images 4 times, each
    # draw its own), fed by prefetch_to_device against copies on the compute
    # stream, in turns; then one epoch on the host loader.
    rep = RepeatedDataset(ds, 4)
    with tempfile.TemporaryDirectory() as tmp:

        def fit_epoch_s(feed, **kw):
            fcfg = dataclasses.replace(tcfg, freeze_epochs=0, total_epochs=1, **kw)
            prefetch, T.prefetch_to_device = T.prefetch_to_device, feed
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.fit(preset, fcfg, rep, log_dir=tmp, init_state=aug_state, device=dev)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            finally:
                T.prefetch_to_device = prefetch

        feeds = {"compute": copies_on_compute_stream, "side": T.prefetch_to_device}
        turns = {k: [] for k in feeds}
        for k in ("compute", "side", "side", "compute"):
            turns[k].append(fit_epoch_s(feeds[k], device_augment=True))
        host_s = fit_epoch_s(T.prefetch_to_device)
    n_steps = len(rep) // bsz
    print(f"[augment] fit, one epoch of {n_steps} steps ({len(rep)} images), s/epoch (host clock, the "
          f"loader's first two batches included): device loader in turns C S S C, copies on the compute "
          f"stream (C) {[round(v, 3) for v in turns['compute']]}, prefetch_to_device (S) "
          f"{[round(v, 3) for v in turns['side']]}: {n_steps / statistics.median(turns['side']):.2f} steps/s (S); "
          f"host loader (S) {host_s:.3f} s, {n_steps / host_s:.2f} steps/s [{card}]")

    # Where the time of a device-augment step goes.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            aug_step(aug_state, u8, plan16, targets, anchors)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / 3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1000 / 3
    print(f"[profile] device-augment step bf16 bs{bsz} under the profiler: wall {wall_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1000 / 3:8.3f} ms/step "
              f"{e.count // 3:5d}x {e.key[:90]}")
    del aug_state
    torch.cuda.empty_cache()

    # K2 on the augmented batch's targets.
    boxes, valid = targets.boxes, targets.valid
    got = matching_cuda.match_front(boxes, anchors, valid)
    want = M.match_front_plain(boxes, anchors, valid)
    torch.cuda.synchronize()
    err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want))
    bits = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    check(err == 0.0 and bits and all(torch.equal(x, y) for x, y in zip(got, want)),
          "K2 == plain on the augmented targets")
    ms = cuda_ms(lambda: matching_cuda.match_front(boxes, anchors, valid), iters=50)
    dev_ms = device_ms(lambda: matching_cuda.match_front(boxes, anchors, valid))
    p = anchors.shape[0]
    kbytes = boxes.numel() * 4 + valid.numel() + anchors.numel() * 4 + bsz * p * (4 + 8) + bsz * g * 8
    bytes_ms = kbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = match_ops(boxes, valid, anchors, matching_cuda._library().jabd_match_tile()) / F32_FLOPS * 1e3
    print(f"[augment] K2 match_front on the augmented targets, B={bsz} G={g} P={p}, {n_valid} valid GTs: "
          f"bit-identical to plain; kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), bytes bound "
          f"{bytes_ms:.6f} ms, operations bound {ops_ms:.6f} ms [{card}]")
    print(f"[augment] K2 launches per path {launches}")
    return {"launches": sum(launches.values()), "max_abs_err": err}


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "golden_e2e")
# tests/test_golden_e2e.py's PredictConfig of the trained fixture.
GOLDEN_PCFG = dict(confidence=0.5, nms_iou=0.3, input_shape=(96, 96), max_detections=32, pre_nms_topk=64)


def write_gt_mats(root: str, events) -> str:
    """wider_face_val.mat and the easy / medium / hard mats, in the
    official nested cell layout, for events = {event: {stem: [N, 4] x y w
    h}} (every face kept in every setting). scipy, imported here."""
    from scipy.io import savemat

    e = len(events)
    event_list, file_list, box_list, keep_list = (np.empty((e, 1), object) for _ in range(4))
    for i, (event, imgs) in enumerate(events.items()):
        event_list[i, 0] = event
        files, boxes, keeps = (np.empty((len(imgs), 1), object) for _ in range(3))
        for j, (stem, gt) in enumerate(imgs.items()):
            files[j, 0] = stem
            boxes[j, 0] = np.asarray(gt, float).reshape(-1, 4)
            keeps[j, 0] = np.arange(1, len(gt) + 1).reshape(-1, 1)
        file_list[i, 0], box_list[i, 0], keep_list[i, 0] = files, boxes, keeps
    os.makedirs(root, exist_ok=True)
    savemat(os.path.join(root, "wider_face_val.mat"),
            {"face_bbx_list": box_list, "event_list": event_list, "file_list": file_list})
    for name in ("easy", "medium", "hard"):
        savemat(os.path.join(root, f"wider_{name}_val.mat"), {"gt_list": keep_list})
    return root


def profiled(fn):
    """(wall ms, device-busy ms, K1 device ms) of one fn() under
    torch.profiler (CUDA kernels only); busy None when not measured."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        return wall, None, None
    k1 = sum(e.self_device_time_total for e in rows if "nms" in e.key.lower()) / 1000
    return wall, sum(e.self_device_time_total for e in rows) / 1000, k1


def wider_phase(card, dev, preset, state):
    """Drive the rest of inference (module docstring, phase 7). Returns
    K1's launches on these paths and its largest error against the plain
    version here."""
    tmp = tempfile.mkdtemp(prefix="wider_")
    try:
        return _wider_paths(card, dev, preset, state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _wider_paths(card, dev, preset, state, tmp):
    import dataclasses

    from jabd_tpu_torch import configs
    from jabd_tpu_torch.eval.run_wider import run_wider_val
    from jabd_tpu_torch.eval.wider_eval import evaluate_wider
    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import image as I
    from jabd_tpu_torch.ops import nms as N
    from jabd_tpu_torch.ops import nms_cuda
    from jabd_tpu_torch.predict import Predictor, map_txt_rows, select_candidates
    from jabd_tpu_torch.utils.np_ckpt import load_variables_npz

    counter = nms_cuda.nms_keep_sorted
    launches, worst = {}, 0.0

    def driven(name, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = counter.launches
        check(counter.launches > 0, f"{name} launched K1")
        return out

    # (a) The trained golden fixture through the sweep, from memory.
    gcfg = dataclasses.replace(configs.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    gstate = load_variables_npz(os.path.join(GOLDEN_DIR, "ckpt_mnet025_96.npz"),
                                build_model(gcfg, device="cpu").state_dict())
    gpred = Predictor(gcfg, gstate, configs.PredictConfig(**GOLDEN_PCFG), device=dev)
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "golden.npz")))
    stems = sorted(k[len("dets_"):] for k in golden if k.startswith("dets_"))
    # Named .jpg, as the golden test's dump names them: the evaluator's
    # txt reader strips only that extension.
    source = {("0--Golden", s + ".jpg"): read_png(os.path.join(GOLDEN_DIR, "images", s + ".png")) for s in stems}
    preds = driven("golden sweep", lambda: run_wider_val(gpred, source, batch_size=3, out_dir=os.path.join(tmp, "golden")))
    box_err = score_err = 0.0
    for s in stems:
        got, want = preds["0--Golden"][s], map_txt_rows(golden["dets_" + s])
        check(got.shape == want.shape, f"golden {s}: {len(got)} detections, golden {len(want)}")
        box_err = max(box_err, float(np.abs(got[:, :4] - want[:, :4]).max()))
        score_err = max(score_err, float(np.abs(got[:, 4] - want[:, 4]).max()))
    gt = write_gt_mats(os.path.join(tmp, "golden_gt"), {"0--Golden": {s: golden["gt_" + s] for s in stems}})
    aps = evaluate_wider(os.path.join(tmp, "golden"), gt, iou_thresh=0.4)
    ap_err = float(np.abs(np.asarray([aps["easy"], aps["medium"], aps["hard"]]) - golden["aps"]).max())
    print(f"[wider] (a) golden fixture through run_wider_val (retinaface_mnet025 f32, 96x96, in-memory PNGs): "
          f"detections {[len(preds['0--Golden'][s]) for s in stems]} (golden "
          f"{[len(golden['dets_' + s]) for s in stems]}), max box err {box_err:.3e} px, score err "
          f"{score_err:.3e}; APs {[round(aps[k], 6) for k in ('easy', 'medium', 'hard')]} against "
          f"{golden['aps'].tolist()}, max err {ap_err:.3e}")
    check(box_err <= 2e-2 and score_err <= 1e-3, "golden detections within 2e-2 px and 1e-3")
    check(ap_err <= 5e-3, "golden APs within 5e-3")

    # (b) The flagship at full width over seeded images of WIDER FACE's
    # geometry, in all three sweep modes.
    pcfg = configs.PredictConfig(confidence=0.02)  # 1280x1280, top 5000, 750 dets
    pred = Predictor(preset, state, pcfg, device=dev)
    n_img, bsz = 64, 32
    ds = wider_in_memory(n_img, 840, seed=7)
    events = ("0--Parade", "1--Handshaking")
    data, gts = {}, {e: {} for e in events}
    for i, (img, anno) in enumerate(zip(ds.images, ds.annos)):
        event = events[i * len(events) // n_img]
        data[(event, f"{i}.jpg")] = np.ascontiguousarray(img[:, :, ::-1])  # RGB -> BGR, as cv2 decodes
        gts[event][str(i)] = np.stack([anno[:, 0], anno[:, 1], anno[:, 2] - anno[:, 0], anno[:, 3] - anno[:, 1]], 1)
    gt = write_gt_mats(os.path.join(tmp, "synthetic_gt"), gts)
    print(f"[wider] (b) {n_img} seeded images {WIDER_WIDTH} px wide (heights "
          f"{sorted({im.shape[0] for im in ds.images})}), {sum(len(a) for a in ds.annos)} faces; "
          f"jabd_flagship bf16 at {pcfg.input_shape}, confidence {pcfg.confidence}, batch {bsz}")
    run_wider_val(pred, dict(list(data.items())[:bsz]), batch_size=bsz)  # warm-up: cuDNN, allocator
    scales = (0.75, 1.0, 1.25)  # run_wider_val's pyramid
    modes = {"single": {}, "multiscale host": {"multiscale": True, "scales": scales},
             "multiscale device": {"multiscale": True, "scales": scales, "pyramid": "device"}}
    first_chunk = dict(list(data.items())[:bsz])
    for mode, kw in modes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = driven(f"sweep {mode}", lambda: run_wider_val(pred, data, batch_size=bsz, **kw))
        wall_s = time.perf_counter() - t0
        aps = evaluate_wider(preds, gt, iou_thresh=0.4)
        n_dets = sum(len(r) for ev in preds.values() for r in ev.values())
        check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aps.values()), f"{mode}: APs finite in [0, 1]")
        check(sum(len(ev) for ev in preds.values()) == n_img, f"{mode}: every image answered")
        wall, busy, k1 = profiled(lambda: run_wider_val(pred, first_chunk, batch_size=bsz, **kw))
        share = "not measured" if busy is None else f"{1 - busy / wall:.3f}"
        per_batch = None if busy is None else busy / (len(scales) if kw else 1)  # a batch per scale
        print(f"[wider] (b) sweep {mode}: {n_img / wall_s:.2f} img/s over the sweep ({wall_s:.2f} s, host clock, "
              f"loading included), {launches[f'sweep {mode}']} K1 launches, {n_dets} detections, APs "
              f"{[round(aps[k], 6) for k in ('easy', 'medium', 'hard')]}; one chunk of {bsz} under the profiler: "
              f"wall {wall:.1f} ms, device busy {fmt_ms(busy)} ({fmt_ms(per_batch)} per batch of {bsz}; K1 "
              f"{fmt_ms(k1)}), host share {share} [{card}]")

    # The sweep's host stages on one chunk (host clock, 8 threads as the
    # sweep runs them): per-image preprocessing of each mode, the float32
    # batch's stacking and copy to the card, and the pyramid's merge
    # (`nms_numpy` over three scales' worth of rows per image).
    th, tw = pcfg.input_shape
    chunk = list(first_chunk.values())

    def host_ms(fn):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            out = list(pool.map(fn, chunk))
        return (time.perf_counter() - t0) * 1000, out

    lb_ms, frames_list = host_ms(lambda im: I.serving_front_end(im, (tw, th)))
    pyr_ms, _ = host_ms(lambda im: [I.serving_front_end(I.cubic_resize_np(im, (max(int(im.shape[1] * s), 32),
                                                                               max(int(im.shape[0] * s), 32))),
                                                        (tw, th)) for s in scales])
    plan_ms, _ = host_ms(lambda im: [I.plan_pyramid(im.shape[:2], s, (th, tw)) for s in scales])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = np.stack(frames_list)
    torch.from_numpy(frames).to(dev)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1000
    single = pred.detect_images(chunk[:4])
    merged = [np.concatenate([d, d * np.float32(1.01), d * np.float32(0.99)]) for d in single]
    t0 = time.perf_counter()
    for m in merged:
        N.nms_numpy(m[:, :4], m[:, 4], iou_threshold=pcfg.nms_iou)
    merge_ms = (time.perf_counter() - t0) * 1000 / len(merged) * len(chunk)
    print(f"[wider] (b) host stages for a chunk of {len(chunk)}, 8 threads: letterbox + means {lb_ms:.1f} ms, "
          f"host pyramid (3 cubic pre-scales + letterboxes) {pyr_ms:.1f} ms, device-pyramid plans {plan_ms:.1f} "
          f"ms; stack + copy of the {frames.nbytes / 1e6:.0f} MB float32 batch {copy_ms:.1f} ms; pyramid merge "
          f"(nms_numpy on {len(merged[0])} rows an image) {merge_ms:.1f} ms, one thread [{card}]")

    # K1 against the plain keep masks on one sweep batch (B 32, K 5000).
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (th, tw)).copy()).to(dev)
    with torch.inference_mode():
        heads = pred.model(torch.from_numpy(frames).to(dev).permute(0, 3, 1, 2))
        kb, _, kv, _ = select_candidates(*heads, anchors, pcfg, preset.anchors.variance)
    kb, kv = kb.contiguous(), kv.contiguous()
    thr, kind = pcfg.nms_iou, pcfg.nms_kind
    keep_k = nms_cuda.nms_keep_sorted(kb, kv, thr, kind)
    keep_p = N.nms_keep_sorted(kb, kv, thr, kind)
    torch.cuda.synchronize()
    err = float((keep_k.float() - keep_p.float()).abs().max())
    worst = max(worst, err)
    check(torch.equal(keep_k, keep_p), "K1 == plain on a sweep batch")
    b, k = kv.shape
    nb = -(-k // 64)
    ms = cuda_ms(lambda: nms_cuda.nms_keep_sorted(kb, kv, thr, kind), iters=20)
    dev_ms = device_ms(lambda: nms_cuda.nms_keep_sorted(kb, kv, thr, kind))
    plain_ms = cuda_ms(lambda: N.nms_keep_sorted(kb, kv, thr, kind), iters=1, warmup=0)
    bytes_ms = (b * k * (16 + 1) + b * k) / HBM_BYTES_PER_S * 1e3
    ops_ms = nms_ops(kv, keep_p, kind) / F32_FLOPS * 1e3
    print(f"[wider] (b) K1 on a sweep batch B={b} K={k}: n_valid per image {kv.sum(1).tolist()}, kept "
          f"{keep_p.sum(1).tolist()}, mismatches {int((keep_k != keep_p).sum())}; mask scratch "
          f"{b * nb * nb * 64 * 8 / 1e6:.1f} MB; kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
          f"{plain_ms:.3f} ms, bytes bound {bytes_ms:.6f} ms, operations bound {ops_ms:.6f} ms [{card}]")

    # (c) Frames: device letterbox and pyramid against the host recipes.
    imgs = list(first_chunk.values())[:8]
    bh = -(-max(im.shape[0] for im in imgs) // 128) * 128
    bw = -(-max(im.shape[1] for im in imgs) // 128) * 128
    padded, parts = zip(*(I.plan_letterbox(im, (th, tw), (bh, bw)) for im in imgs))
    src = torch.from_numpy(np.stack(padded)).to(dev)
    plan = [torch.from_numpy(np.stack(p)).to(dev) for p in zip(*parts)]
    host = torch.from_numpy(np.stack([I.serving_front_end(im, (tw, th)) for im in imgs]))
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with torch.inference_mode():
            got = I.letterbox_batch_device(src, *plan, resample_dtype=dt).cpu()
        e = (got - host).abs()
        mean, share = float(e.flatten(1).mean(1).max()), float((e.amax(-1) > 4).flatten(1).float().mean(1).max())
        print(f"[wider] (c) letterbox_batch_device {name} vs host letterbox, {len(imgs)} images at bucket "
              f"{(bh, bw)}: max {float(e.max()):.3f}, worst image mean {mean:.4f}, share over 4 {share:.5f}")
        check(mean <= 0.5 and share <= 0.005, f"device letterbox {name} within the JAX test's bounds")
    worst_pyr = 0.0
    for scale in (0.75, 1.0, 1.25):
        plans = [I.plan_pyramid(im.shape[:2], scale, (th, tw)) for im in imgs[:4]]
        srcp = torch.from_numpy(np.stack([I.pad_to_bucket(im, (bh, bw)) for im in imgs[:4]])).to(dev)
        parts = [torch.from_numpy(np.stack([p[0][i] for p in plans])).to(dev) for i in range(6)]
        with torch.inference_mode():
            got = I.pyramid_batch_device(srcp, *parts).cpu()
        for i, (im, (_, (sh, sw))) in enumerate(zip(imgs[:4], plans)):
            want = I.preprocess_input_np(I.letterbox_np(I.cubic_resize_np(im, (sw, sh)), (tw, th)))
            worst_pyr = max(worst_pyr, float((got[i] - torch.from_numpy(want)).abs().max()))
    print(f"[wider] (c) pyramid_batch_device f32 (TF32 off) vs the host two-stage recipe, 4 images x 3 scales: "
          f"max {worst_pyr:.3e}")
    check(worst_pyr <= 0.05, "device pyramid within 0.05 of the host recipe")

    # (d) detect_images, and the nms twin of nms_pallas.
    rng = np.random.default_rng(11)
    gimg = read_png(os.path.join(GOLDEN_DIR, "images", stems[0] + ".png"))
    ident = np.ascontiguousarray(gimg[:96, :96])  # the target's own size: a copy, no resampling
    mixed = [ident, read_png(os.path.join(GOLDEN_DIR, "images", stems[1] + ".png")),
             rng.integers(0, 256, (70, 150, 3), dtype=np.uint8), imgs[0]]
    outs = driven("detect_images golden", lambda: gpred.detect_images(mixed))
    single = gpred.detect_image(ident)
    check(outs[0].shape == single.shape, "detect_images identity image: as many rows as detect_image")
    ident_err = float(np.abs(outs[0] - single).max()) if len(single) else 0.0
    check(ident_err <= 2e-3, "detect_images identity image within 2e-3 px of detect_image")
    flag = driven("detect_images flagship", lambda: pred.detect_images(imgs[:3] + [imgs[3][:700, :500]]))
    check(all(np.isfinite(d).all() and d.shape[1] == 15 for d in flag), "flagship detect_images dets finite")
    print(f"[wider] (d) detect_images: golden fixture rows {[len(d) for d in outs]}, identity image vs "
          f"detect_image max err {ident_err:.3e} px; flagship bf16 rows {[len(d) for d in flag]}")
    max_k = nms_cuda._library().jabd_nms_max_k()
    for n in (5000, max_k):
        boxes = torch.from_numpy(np.clip(_random_boxes(rng, n), 0, 1)).to(dev)
        boxes[: n // 10] = boxes[0]
        scores = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
        scores[::3] = 0.5  # ties: the stable order decides
        valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        idx, ok = driven(f"nms N={n}", lambda: nms_cuda.nms(boxes, scores, 0.3, 750, valid))
        pidx, pok = N.nms(boxes, scores, 0.3, 750, valid)
        torch.cuda.synchronize()
        check(torch.equal(idx, pidx) and torch.equal(ok, pok), f"nms_cuda.nms == plain nms at N {n}")
        print(f"[wider] (d) nms_cuda.nms N={n}: {int(ok.sum())} kept, identical to the plain nms")
    try:
        nms_cuda.nms(torch.zeros((max_k + 1, 4), device=dev), torch.zeros(max_k + 1, device=dev))
        check(False, f"nms_cuda.nms raises at N {max_k + 1}")
    except ValueError as e:
        print(f"[wider] (d) nms_cuda.nms N={max_k + 1} raises: {e}")
    print(f"[wider] K1 launches per path {launches}")
    return {"launches": sum(launches.values()), "max_abs_err": worst}


# ---------------------------------------------------------------------------
# Phase 8: the other 14 detector presets
# ---------------------------------------------------------------------------

NEW_PRESETS = (
    "jabd_pixelshuffle", "mnet_v3_4level", "re50_eca_nonlocal", "re50_dropout",
    "re50_baseline", "re50_self_4level", "re152_4level", "re50_fpn_att",
    "re50_backbone_att", "re50_contrast_eca", "re50_nonlocal", "re50_eca_hsigmoid",
    "re50_iou_head", "epsa50_4level",
)
TIMED_PRESETS = ("re50_eca_nonlocal", "re152_4level", "epsa50_4level", "mnet_v3_4level")
# Square input sides: (a) heads, (b) serving, (c) K2's priors.
PRESETS_HEADS_SIZE, PRESETS_SERVE_SIZE, PRESETS_MATCH_SIZE = 320, 640, 840


def profile_rows(fn, iters: int, unit: str, card: str, tag: str, top: int = 8, phase: str = "[presets]") -> None:
    """Wall and device time of `fn()` under torch.profiler over `iters`
    calls, with its top kernels by device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / iters
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1000 / iters
    print(f"{phase} {tag} under the profiler: wall {wall_ms:.3f} ms/{unit}, device busy {busy_ms:.3f} "
          f"ms/{unit}, idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows) / iters:.0f} "
          f"kernels/{unit} [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{phase}   {e.self_device_time_total / 1000 / iters:8.3f} ms/{unit} "
              f"{e.count // iters:5d}x {e.key[:90]}")


def presets_eval(card, dev, name, calib, x2, batch8, pcfg, counts):
    """(a) the preset's float32 heads on the card against the CPU and its
    bfloat16 heads finite; (b) its bf16 Predictor, bs 8, which must launch
    K1 on 5,000 valid candidates an image (re50_iou_head must raise). Adds the K1 launches to `counts`; returns the largest K1 -
    plain difference it saw."""
    import dataclasses

    from jabd_tpu_torch import configs
    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.models.fold import fold_batchnorm
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import nms as N
    from jabd_tpu_torch.ops import nms_cuda
    from jabd_tpu_torch.predict import Predictor, postprocess_outputs, select_candidates

    preset = configs.get_model_config(name)
    cfg32 = dataclasses.replace(preset, compute_dtype="float32")
    state = seeded_state_dict(preset, seed=NEW_PRESETS.index(name) + 1, calibrate=calib)
    models = []
    for where in ("cpu", "cpu", dev):
        models.append(build_model(cfg32, mode="eval", device=where))
        models[-1].load_state_dict(state)
        models[-1].eval()
    xin = torch.from_numpy(x2).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ref = models[0](xin)
        ref64 = models[1].double()(xin.double())
        got = models[2](xin.to(dev))
        got16 = fold_batchnorm(models[2]).to(torch.bfloat16)(xin.to(dev))
    del models
    parts = []
    for head, r, r64, g, h in zip(("loc", "cls", "landm", "iou"), ref, ref64, got, got16):
        err = float((g.cpu() - r).abs().max())
        scale = max(1.0, float(r.abs().max()))
        # Which side float64 (CPU) is nearer, for the record; the check is
        # card f32 against CPU f32.
        e64 = (float((g.cpu().double() - r64).abs().max()), float((r.double() - r64).abs().max()))
        parts.append(f"{head} err {err:.3e} max|ref| {float(r.abs().max()):.3e} bound {1e-3 * scale:.3e} "
                     f"(vs CPU f64: card {e64[0]:.1e}, CPU f32 {e64[1]:.1e})")
        check(err <= 1e-3 * scale, f"{name} {head}: card f32 within 1e-3 * max(1, max|ref|) of the CPU")
        check(bool(torch.isfinite(h).all()), f"{name} {head}: bf16 finite")
    face = ref[1][..., 1]
    print(f"[presets] (a) {name} f32 {x2.shape[1]}x{x2.shape[2]} bs2: " + "; ".join(parts)
          + f"; face score min {float(face.min()):.4f} max {float(face.max()):.4f}; bf16 finite")

    if preset.with_iou_head:
        try:
            Predictor(preset, state, pcfg, device=dev)
            check(False, f"{name}: Predictor raises on the IoU head")
        except ValueError as e:
            print(f"[presets] (b) {name}: Predictor raises: {e}")
        return 0.0
    p16 = Predictor(preset, state, pcfg, device=dev)
    reset_counts()
    dets, valid = p16.detect_preprocessed(batch8)
    torch.cuda.synchronize()
    launched = nms_cuda.nms_keep_sorted.launches
    counts[name] = launched
    check(launched > 0, f"{name}: detect_preprocessed launched K1")
    check(tuple(dets.shape) == (8, 750, 15) and bool(torch.isfinite(dets).all()), f"{name}: dets finite")
    x8 = torch.from_numpy(batch8).to(dev)
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, batch8.shape[1:3]).copy()).to(dev)
    var = preset.anchors.variance
    with torch.inference_mode():
        heads = p16.model(x8.permute(0, 3, 1, 2))
        cand_boxes, _, cand_valid, _ = select_candidates(*heads, anchors, pcfg, var)
    n_valid = cand_valid.sum(1).tolist()
    want = min(pcfg.pre_nms_topk, anchors.shape[0])
    check(all(n == want for n in n_valid), f"{name}: {want} valid candidates an image")
    worst = 0.0
    line = (f"[presets] (b) {name} bf16 {batch8.shape[1]}x{batch8.shape[2]} bs8: K1 launches {launched}, valid candidates per image "
            f"{n_valid}, dets per image {valid.sum(1).tolist()}")
    if name == "re50_eca_nonlocal":
        with torch.inference_mode():
            d_k, v_k = postprocess_outputs(*heads, anchors, pcfg, var)
            d_p, v_p = postprocess_outputs(*heads, anchors, pcfg, var, keep_fn=N.nms_keep_sorted)
            kb, kv = cand_boxes.contiguous(), cand_valid.contiguous()
            keep_k = nms_cuda.nms_keep_sorted(kb, kv, pcfg.nms_iou, pcfg.nms_kind)
            keep_p = N.nms_keep_sorted(kb, kv, pcfg.nms_iou, pcfg.nms_kind)
        torch.cuda.synchronize()
        same = torch.equal(v_k, v_p) and torch.equal(d_k, d_p) and torch.equal(keep_k, keep_p)
        worst = float((keep_k.float() - keep_p.float()).abs().max())
        check(same, f"{name}: K1 keep masks and dets == plain NMS")
        line += f"; K1 keep masks and dets identical to the plain NMS (kept {keep_p.sum(1).tolist()})"
    print(line)
    if name in TIMED_PRESETS:
        ms = back_to_back_ms(lambda: p16._detect(x8), iters=10)
        print(f"[presets] (b) {name} bf16 bs8 {batch8.shape[1]}x{batch8.shape[2]}: back-to-back {ms:.3f} ms/batch "
              f"({8000 / ms:.1f} img/s) [{card}]")
        if name in ("re50_eca_nonlocal", "re152_4level"):
            profile_rows(lambda: p16._detect(x8), 3, "batch", card, f"(b) {name} serving bf16 bs8")
    del p16
    torch.cuda.empty_cache()
    return worst


def presets_train(card, dev, name, tcfg, counts, steps: int = 5):
    """(d) bf16 train steps of `name` at tcfg's size and batch on one batch:
    loss finite and lower after `steps`, ms/step, img/s, peak memory, K2
    launches. Returns False when the batch does not fit on the card."""
    from jabd_tpu_torch import configs
    from jabd_tpu_torch import train as T
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import matching_cuda

    preset = configs.get_model_config(name)
    size, bsz, g = tcfg.image_size, tcfg.batch_size, tcfg.max_targets
    rng = np.random.default_rng(10)
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (size, size)).copy()).to(dev)
    images = torch.from_numpy(rng.normal(0, 50, (bsz, size, size, 3)).astype(np.float32)).to(dev)
    targets = to_targets(batch_targets(face_rows(rng, np.maximum(spread_counts(bsz, g), 1)), g), dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        state = T.create_train_state(preset, tcfg, 1, freeze_backbone=False, device=dev)
        step = T.make_train_step(preset, tcfg)
        reset_counts()
        losses = [step(state, images, targets, anchors)[1]["loss"] for _ in range(steps)]
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        print(f"[presets] (d) {name} bs{bsz} remat={tcfg.remat}: out of memory")
        return False
    launched = matching_cuda.match_front.launches
    counts[f"{name} train_step x{steps}"] = launched
    check(launched > 0, f"{name}: the train step launched K2")
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals = [float(v) for v in losses]
    check(all(np.isfinite(vals)) and vals[-1] < vals[0], f"{name}: bf16 loss finite and lower after {steps} steps")
    ms = back_to_back_ms(lambda: step(state, images, targets, anchors), iters=3, warmup=1)
    print(f"[presets] (d) {name} bf16 bs{bsz} {size}x{size} remat={tcfg.remat}: P {anchors.shape[0]}, losses "
          f"{[round(v, 4) for v in vals]}, K2 launches {launched}; back-to-back {ms:.3f} ms/step "
          f"({1000 * bsz / ms:.1f} img/s), peak memory {peak:.2f} GiB [{card}]")
    profile_rows(lambda: step(state, images, targets, anchors), 2, "step", card,
                 f"(d) {name} train step bf16 bs{bsz} remat={tcfg.remat}")
    return True


def presets_phase(card, dev):
    """The other 14 presets (see the module docstring, phase 8). Returns
    the K1 and K2 numbers for the kernels line."""
    import dataclasses

    from jabd_tpu_torch import configs
    from jabd_tpu_torch.data.wider import batch_targets
    from jabd_tpu_torch.models import retinaface as RF
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import matching as M
    from jabd_tpu_torch.ops import matching_cuda

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    hs, ss = PRESETS_HEADS_SIZE, PRESETS_SERVE_SIZE
    calib = torch.from_numpy(rng.normal(0, 50, (4, 3, hs, hs)).astype(np.float32)).to(dev)
    x2 = rng.normal(0, 50, (2, hs, hs, 3)).astype(np.float32)
    batch8 = rng.normal(0, 50, (8, ss, ss, 3)).astype(np.float32)
    pcfg = configs.PredictConfig(confidence=0.02, input_shape=(ss, ss))
    k1_counts = {}
    k1_err = 0.0
    for name in NEW_PRESETS:
        k1_err = max(k1_err, presets_eval(card, dev, name, calib, x2, batch8, pcfg, k1_counts))
    print(f"[presets] (b) K1 launches per preset {k1_counts} ({time.perf_counter() - t0:.1f} s so far)")

    # (c) K2 against the plain front half at re152_4level's priors.
    side = PRESETS_MATCH_SIZE
    priors_np = A.generate_anchors(configs.get_model_config("re152_4level").anchors, (side, side)).copy()
    k2_err = matching_phase(dev, priors_np, tag="[presets] (c)")
    b, g = 34, 128
    priors = torch.from_numpy(priors_np).to(dev)
    t = to_targets(batch_targets(face_rows(np.random.default_rng(4), spread_counts(b, g)), g), dev)
    ms = cuda_ms(lambda: matching_cuda.match_front(t.boxes, priors, t.valid), iters=30)
    dev_ms = device_ms(lambda: matching_cuda.match_front(t.boxes, priors, t.valid))
    plain_ms = cuda_ms(lambda: M.match_front_plain(t.boxes, priors, t.valid), iters=5)
    p = priors.shape[0]
    nbytes = t.boxes.numel() * 4 + t.valid.numel() + priors.numel() * 4 + b * p * (4 + 8) + b * g * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = match_ops(t.boxes, t.valid, priors, matching_cuda._library().jabd_match_tile()) / F32_FLOPS * 1e3
    print(f"[presets] (c) K2 match_front B={b} G={g} P={p}, {int(t.valid.sum())} valid GTs (spread): kernel "
          f"{ms:.4f} ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bytes bound {bytes_ms:.6f} ms, "
          f"operations bound {ops_ms:.6f} ms [{card}]")
    del t, priors
    torch.cuda.empty_cache()

    # (d) bf16 train steps at TrainConfig's 840x840: re50_eca_nonlocal plain at bs 34,
    # re152_4level with remat at the largest of 34, 17, 8 that fits.
    k2_counts = {}
    tcfg = configs.TrainConfig()
    check(presets_train(card, dev, "re50_eca_nonlocal", tcfg, k2_counts), "re50_eca_nonlocal bs34 fits")
    for bsz in (34, 17, 8):
        if presets_train(card, dev, "re152_4level", dataclasses.replace(tcfg, batch_size=bsz, remat=True), k2_counts):
            break
    else:
        check(False, "re152_4level trains at batch 8 with remat")

    # re50_dropout: a train step with the taps' dropout, its share and scale.
    from jabd_tpu_torch import train as T

    name = "re50_dropout"
    preset = configs.get_model_config(name)
    dcfg = dataclasses.replace(tcfg, batch_size=8)
    state = T.create_train_state(preset, dcfg, 1, freeze_backbone=False, device=dev)
    model = state.model
    seen, raw = {}, {}
    hooks = [getattr(model, f"eca_tap{i + 1}").register_forward_pre_hook(
        lambda m, a, i=i: seen.__setitem__(i, a[0].detach().clone())) for i in range(3)]
    hooks.append(model.backbone.register_forward_hook(
        lambda m, a, out: raw.update((i, o.detach().clone()) for i, o in enumerate(out))))
    rng = np.random.default_rng(11)
    size = dcfg.image_size
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (size, size)).copy()).to(dev)
    images = torch.from_numpy(rng.normal(0, 50, (8, size, size, 3)).astype(np.float32)).to(dev)
    targets = to_targets(batch_targets(face_rows(rng, [20] * 8), 128), dev)
    reset_counts()
    _, metrics = T.make_train_step(preset, dcfg)(state, images, targets, anchors)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    k2_counts[f"{name} train_step"] = matching_cuda.match_front.launches
    check(matching_cuda.match_front.launches > 0, f"{name}: the train step launched K2")
    shares = []
    for i in range(3):
        live = raw[i] != 0
        kept = seen[i] != 0
        shares.append(1.0 - float(kept[live].float().mean()))
        check(abs(shares[-1] - 0.5) <= 0.01, f"{name} tap {i + 1}: drop share within 0.5 +- 0.01")
        check(torch.equal(seen[i][kept], 2.0 * raw[i][kept]) and not bool(kept[~live].any()),
              f"{name} tap {i + 1}: kept values scaled by 2")
    print(f"[presets] (d) {name} bf16 bs8 train step (dropout stream {RF.dropout_seed(dcfg.seed, 0)}): loss "
          f"{float(metrics['loss']):.4f}, tap drop shares {[round(s, 5) for s in shares]}, kept values x2")
    del state, model, seen, raw
    torch.cuda.empty_cache()
    print(f"[presets] K2 launches per path {k2_counts}; phase {time.perf_counter() - t0:.1f} s")
    return ({"launches": sum(k1_counts.values()), "max_abs_err": k1_err},
            {"launches": sum(k2_counts.values()), "max_abs_err": k2_err})


# ---------------------------------------------------------------------------
# Phase 9: the app surface (CLI, daemon, artifacts, int8, .pth names)
# ---------------------------------------------------------------------------

# Sizes of the [app] phase: the flagship's serving shape and the training
# recipe's, as cli.py's users run them. A CPU rehearsal may shrink them.
APP_SIZE, APP_BATCH, APP_TRAIN_SIZE, APP_TRAIN_BATCH = 640, 8, 840, 34
# Bound of the daemon's and the artifact's detections against the live
# Predictor's, in pixels: the JSON rounds to 1e-3, and batch 8 against
# batch 1 may run other cuDNN algorithms (float32, TF32 off: ~1e-5 px).
APP_DET_TOL = 5e-3


def run_cli(argv):
    """cli.main(argv) in this process (the launch counts stay visible);
    returns its standard output, also echoed under an [app] prefix."""
    import contextlib
    import io

    from jabd_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([str(a) for a in argv])
    out = buf.getvalue()
    for line in out.splitlines()[-3:]:
        print(f"[app]   cli {argv[0]}: {line[:160]}")
    return out


def last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def read_dumps(root: str) -> dict:
    """{(event, stem): [N, 5] rows} of a map-txt dump tree."""
    out = {}
    for event in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, event))):
            with open(os.path.join(root, event, name)) as f:
                lines = f.read().splitlines()
            rows = np.asarray([[float(v) for v in ln.split()] for ln in lines[2:]], np.float64).reshape(-1, 5)
            check(int(lines[1]) == len(rows), f"{event}/{name}: count line matches its rows")
            out[(event, name[: -len(".txt")])] = rows
    return out


def jpeg_bytes(bgr: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def write_label_tree(root: str, ds) -> str:
    """The images of an in-memory WiderFaceDataset as PNGs under
    root/images/, and root/label.txt in the reference's format (`# path`,
    then per face x y w h and five landmarks as x y visibility)."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    lines = []
    for i, (img, anno) in enumerate(zip(ds.images, ds.annos)):
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.png"), compress_level=1)
        lines.append(f"# {i}.png")
        for r in anno:
            lm = " ".join(f"{r[4 + 2 * p]:.2f} {r[5 + 2 * p]:.2f} {0.0 if r[14] > 0 else -1.0}" for p in range(5))
            lines.append(f"{r[0]:.2f} {r[1]:.2f} {r[2] - r[0]:.2f} {r[3] - r[1]:.2f} {lm} 1.0")
    path = os.path.join(root, "label.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def rows_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest distance from a row of `got` to its nearest row of `want`
    and back ([N, 15] dets): near-equal scores may order two sets
    differently."""
    if len(got) == 0 or len(want) == 0:
        return 0.0 if len(got) == len(want) else float("inf")
    d = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    return float(max(d.min(1).max(), d.min(0).max()))


def post(url: str, body: bytes):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def app_phase(card, dev):
    """Drive the app surface (module docstring, phase 9). Returns K1's and
    K2's launches on these paths and the int8 route's largest error."""
    tmp = tempfile.mkdtemp(prefix="app_")
    try:
        return _app_paths(card, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _app_paths(card, dev, tmp):
    import dataclasses
    import threading
    import urllib.request

    from PIL import Image

    from jabd_tpu_torch import aot, configs
    from jabd_tpu_torch.eval.run_wider import decode_bgr, run_wider_val
    from jabd_tpu_torch.eval.wider_eval import evaluate_wider
    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.models import quantize as Q
    from jabd_tpu_torch.ops import image as I
    from jabd_tpu_torch.ops import matching_cuda, nms_cuda
    from jabd_tpu_torch.predict import Predictor
    from jabd_tpu_torch.serve import BatchingDetector, make_server
    from jabd_tpu_torch.utils.np_ckpt import load_variables_npz
    from jabd_tpu_torch.utils.profiling import count_params
    from jabd_tpu_torch.utils.torch_convert import export_state_dict_auto, save_pth

    k1 = nms_cuda.nms_keep_sorted
    launches = {}
    t_phase = time.perf_counter()

    def driven(name, fn, kernel=k1, tag="K1"):
        reset_counts()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[name] = (tag, kernel.launches)
        check(kernel.launches > 0, f"{name} launched {tag}")
        return out

    size, bsz = APP_SIZE, APP_BATCH
    dv = ["--device", dev.type]
    rng = np.random.default_rng(9)

    # (a) Reference .pth names and the CLI on the trained golden fixture.
    t0 = time.perf_counter()
    gname = "retinaface_mnet025"
    gcfg = configs.get_model_config(gname)
    gstate = load_variables_npz(os.path.join(GOLDEN_DIR, "ckpt_mnet025_96.npz"),
                                build_model(gcfg, device="cpu").state_dict())
    gpth = os.path.join(tmp, "golden.pth")
    gsd = export_state_dict_auto(gstate, gcfg)
    save_pth(gsd, gpth)
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "golden.npz")))
    stems = sorted(k[len("dets_"):] for k in golden if k.startswith("dets_"))
    val = os.path.join(tmp, "val")
    os.makedirs(os.path.join(val, "0--Golden"))
    for s in stems:  # PNGs named .jpg: the evaluator's txt reader strips only that extension
        shutil.copy(os.path.join(GOLDEN_DIR, "images", s + ".png"), os.path.join(val, "0--Golden", s + ".jpg"))
    dumps = os.path.join(tmp, "dumps")
    driven("cli map-txt", lambda: run_cli(["map-txt", "--weights", gpth, "--model", gname, "--input-size", 96,
                                           "--confidence", 0.5, "--batch-size", 3, "--val-dir", val,
                                           "--out", dumps, *dv]))
    gt = write_gt_mats(os.path.join(tmp, "golden_gt"), {"0--Golden": {s: golden["gt_" + s] for s in stems}})
    aps = last_json(run_cli(["eval", "--pred-dir", dumps, "--gt-dir", gt]))
    # The in-process twin at the PredictConfig the CLI builds (its
    # defaults: top 5000, 750 detections; the preset's dtype, folded).
    pcfg_cli = configs.PredictConfig(confidence=0.5, nms_iou=0.3, input_shape=(96, 96))
    ref_pred = Predictor(gcfg, gstate, pcfg_cli, device=dev)
    source = {("0--Golden", s + ".jpg"): decode_bgr(os.path.join(val, "0--Golden", s + ".jpg")) for s in stems}
    want = run_wider_val(ref_pred, source, batch_size=3)
    got = read_dumps(dumps)
    box_err = score_err = 0.0
    for s in stems:
        g, w = got[("0--Golden", s)], want["0--Golden"][s]
        check(g.shape == w.shape, f"map-txt {s}: {len(g)} rows, in-process sweep {len(w)}")
        box_err = max(box_err, float(np.abs(g[:, :4] - w[:, :4]).max(initial=0.0)))
        score_err = max(score_err, float(np.abs(g[:, 4] - w[:, 4]).max(initial=0.0)))
    # The dumps print boxes to 1e-3 px and scores to 1e-5.
    check(box_err <= 1e-3 and score_err <= 1e-5, "cli map-txt dumps == the in-process sweep's")
    raw_counts = [int(len(golden["dets_" + s])) for s in stems]
    # Whether golden.npz's cuts (top 64 candidates, 32 detections) bind:
    # candidates over the confidence, and detections, per image.
    n_cand = []
    for s in stems:
        x = torch.from_numpy(I.serving_front_end(source[("0--Golden", s + ".jpg")], (96, 96))[None]).to(dev)
        with torch.inference_mode():
            n_cand.append(int((ref_pred.model(x.permute(0, 3, 1, 2))[1][0, :, 1] >= 0.5).sum()))
    cut_bind = (max(n_cand) > GOLDEN_PCFG["pre_nms_topk"]
                or max(len(got[("0--Golden", s)]) for s in stems) > GOLDEN_PCFG["max_detections"])
    ap_diff = float(np.abs(np.asarray([aps[k] for k in ("easy", "medium", "hard")]) - golden["aps"]).max())
    cut_bind = any(n >= GOLDEN_PCFG["max_detections"] for n in raw_counts)
    print(f"[app] (a) golden fixture as a reference-named .pth ({len(gsd)} "
          f"tensors) -> cli map-txt ({gname}, {gcfg.compute_dtype}, 96x96, batch 3) -> cli eval: rows "
          f"{[len(got[('0--Golden', s)]) for s in stems]} (golden.npz {raw_counts}), against the in-process "
          f"sweep max box err {box_err:.3e} px, score err {score_err:.3e} (bounds 1e-3, 1e-5: the dump's "
          f"digits); APs {[aps[k] for k in ('easy', 'medium', 'hard')]} beside golden.npz "
          f"{golden['aps'].tolist()}, max diff {ap_diff:.3e} (golden.npz: float32, top "
          f"{GOLDEN_PCFG['pre_nms_topk']}, {GOLDEN_PCFG['max_detections']} dets; the CLI: the preset's "
          f"{gcfg.compute_dtype}, top 5000, 750 dets; candidates over the confidence {n_cand}: the "
          f"fixture's cuts {'bind' if cut_bind else 'do not bind'} on these images)")
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aps.values()), "cli eval APs in [0, 1]")
    img0 = os.path.join(val, "0--Golden", stems[0] + ".jpg")
    sub = subprocess.run(
        [sys.executable, "-m", "jabd_tpu_torch.cli", "predict", "--weights", gpth, "--model", gname,
         "--input-size", "96", "--image", img0, "--out", os.path.join(tmp, "sub.png"), *dv],
        capture_output=True, text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    check(sub.returncode == 0, f"python3 -m jabd_tpu_torch.cli predict exits 0: {sub.stderr[-500:]}")
    n_sub = int(sub.stdout.split(" faces")[0].split()[-1])
    n_ref = len(ref_pred.detect_image(decode_bgr(img0)))
    print(f"[app] (a) python3 -m jabd_tpu_torch.cli predict (a subprocess): {n_sub} faces, in-process "
          f"detect_image {n_ref}")
    check(n_sub == n_ref, "subprocess cli predict count == detect_image's")

    preset = configs.get_model_config("jabd_flagship")
    cfg32 = dataclasses.replace(preset, compute_dtype="float32")
    state = seeded_state_dict(preset, seed=3)
    fpth = os.path.join(tmp, "flagship.pth")
    save_pth(export_state_dict_auto(state, preset), fpth)
    frame = smooth_image(rng, 480, 640)[:, :, ::-1].copy()  # BGR
    fimg = os.path.join(tmp, "frame.png")
    Image.fromarray(frame[:, :, ::-1]).save(fimg)
    out = driven("cli predict", lambda: run_cli(["predict", "--weights", fpth, "--model", "jabd_flagship",
                                                 "--input-size", size, "--image", fimg,
                                                 "--out", os.path.join(tmp, "drawn.png"), *dv]))
    n_cli = int(out.split(" faces")[0].split()[-1])
    pcfg = configs.PredictConfig(confidence=0.5, nms_iou=0.3, input_shape=(size, size))
    p16 = Predictor(preset, state, pcfg, device=dev)
    n_live = len(p16.detect_image(frame))
    print(f"[app] (a) cli predict jabd_flagship {preset.compute_dtype} {size}x{size} from a seeded .pth: "
          f"{n_cli} faces, in-process detect_image {n_live} ({time.perf_counter() - t0:.1f} s for (a))")
    check(n_cli == n_live, "cli predict count == detect_image's")

    # (c) The artifact: bf16 flagship, batch 8, loaded in a fresh
    # interpreter that imports aot.py only.
    t0 = time.perf_counter()
    art = os.path.join(tmp, "art16")
    out = run_cli(["export", "--weights", fpth, "--model", "jabd_flagship", "--input-size", size,
                   "--batch-size", bsz, "--out", art, "--platforms", dev.type, *dv])
    art_bytes = last_json(out)["bytes"]
    t_export = time.perf_counter() - t0
    xb = rng.normal(0, 50, (bsz, size, size, 3)).astype(np.float32)
    np.save(os.path.join(tmp, "xb.npy"), xb)
    code = (
        "import json, sys, numpy as np, torch\n"
        "from jabd_tpu_torch import aot\n"
        "from jabd_tpu_torch.ops import nms_cuda\n"
        f"a = aot.load_exported({art!r}, device={dev.type!r})\n"
        f"d, v = a.detect_preprocessed(np.load({os.path.join(tmp, 'xb.npy')!r}))\n"
        f"np.savez({os.path.join(tmp, 'aot_out.npz')!r}, d=d.float().cpu().numpy(), v=v.cpu().numpy())\n"
        "print(json.dumps({'models_imported': 'jabd_tpu_torch.models' in sys.modules,\n"
        "                  'predict_imported': 'jabd_tpu_torch.predict' in sys.modules,\n"
        "                  'k1': nms_cuda.nms_keep_sorted.launches}))\n"
    )
    sub = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(sub.returncode == 0, f"fresh-interpreter artifact load: {sub.stderr[-800:]}")
    fresh = last_json(sub.stdout)
    with np.load(os.path.join(tmp, "aot_out.npz")) as z:
        d_aot, v_aot = z["d"], z["v"]
    d_live, v_live = (t.cpu().numpy() for t in p16.detect_preprocessed(xb))
    det_err = float(np.abs(d_aot - d_live)[v_live].max(initial=0.0))
    print(f"[app] (c) export jabd_flagship bf16 batch {bsz} {size}x{size}: {t_export:.1f} s, bytes {art_bytes}; "
          f"fresh interpreter (aot.py only): models imported {fresh['models_imported']}, predict imported "
          f"{fresh['predict_imported']}, K1 launches {fresh['k1']}; valid masks equal "
          f"{bool(np.array_equal(v_aot, v_live))} ({int(v_live.sum())} dets), max abs det err {det_err:.3e} "
          f"(bound {APP_DET_TOL}, normalized coords)")
    check(not fresh["models_imported"] and not fresh["predict_imported"], "artifact loads without model code")
    check(fresh["k1"] > 0, "the loaded artifact launched K1")
    check(np.array_equal(v_aot, v_live) and det_err <= APP_DET_TOL, "artifact == live Predictor")
    launches["artifact (fresh interpreter)"] = ("K1", fresh["k1"])

    # (b) The daemon: float32 flagship (TF32 off) behind make_server (what
    # `cli serve` starts), 16 concurrent JPEG POSTs; then one artifact.
    t0 = time.perf_counter()
    p32 = Predictor(cfg32, state, pcfg, device=dev)
    frames = [smooth_image(rng, int(h), int(w))[:, :, ::-1].copy()
              for h, w in zip(rng.integers(360, 720, 16), rng.integers(480, 960, 16))]
    bodies = [jpeg_bytes(f) for f in frames]
    decoded = [decode_bgr(b) for b in bodies]
    det = BatchingDetector(p32, batch_size=bsz, max_wait_ms=50.0)
    srv = make_server(det, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        det.detect(decoded[0])  # warm-up: cuDNN, allocator
        before = det.stats()

        def burst():
            with ThreadPoolExecutor(16) as pool:
                return list(pool.map(lambda b: post(url + "/detect", b), bodies))

        t1 = time.perf_counter()
        answers = driven("daemon POST /detect", burst)
        wall = time.perf_counter() - t1
        stats = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
        stats["requests"] -= before["requests"]
        stats["batches"] -= before["batches"]
    finally:
        srv.shutdown()
        srv.server_close()
        det.close()
    worst = 0.0
    for ans, img in zip(answers, decoded):
        ref = p32.detect_image(img)
        got = np.asarray(ans["faces"], np.float64).reshape(-1, 15)
        check(len(got) == len(ref), f"daemon answer has {len(got)} faces, detect_image {len(ref)}")
        worst = max(worst, rows_err(got, ref))
    print(f"[app] (b) daemon jabd_flagship f32 {size}x{size} batch {bsz}: 16 concurrent POSTs in {wall * 1000:.1f} ms "
          f"(host clock), healthz {stats}, K1 launches {launches['daemon POST /detect'][1]}; faces "
          f"{[a['count'] for a in answers]}; max abs err against detect_image {worst:.3e} px (bound "
          f"{APP_DET_TOL}) [{card}]")
    check(worst <= APP_DET_TOL, "daemon answers == detect_image")
    check(stats["requests"] == 16 and stats["batches"] >= 2, "healthz: 16 requests in at least 2 batches")
    check(launches["daemon POST /detect"][1] >= stats["batches"], "K1 launched for every batch")
    # The burst's host stages, one at a time on this thread.
    t1 = time.perf_counter()
    for b in bodies:
        decode_bgr(b)
    dec_ms = (time.perf_counter() - t1) * 1000 / len(bodies)
    t1 = time.perf_counter()
    fronts = [I.serving_front_end(img, (size, size)) for img in decoded]
    fe_ms = (time.perf_counter() - t1) * 1000 / len(bodies)

    def batch_host_to_host():
        d, v = p32.detect_preprocessed(np.stack(fronts[:bsz]))
        return d.cpu(), v.cpu()

    batch_host_to_host()
    t1 = time.perf_counter()
    for _ in range(3):
        batch_host_to_host()
    b_ms = (time.perf_counter() - t1) * 1000 / 3
    print(f"[app] (b) the burst's stages, host clock: JPEG decode {dec_ms:.1f} ms a request, letterbox + means "
          f"{fe_ms:.1f} ms a request (the collector runs them one by one), f32 batch of {bsz} host->host "
          f"{b_ms:.1f} ms [{card}]")
    aot16 = aot.load_exported(art, device=dev)
    det = BatchingDetector(aot16, batch_size=bsz, max_wait_ms=5.0)
    srv = make_server(det, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        ans = driven("daemon --exported", lambda: post(f"http://127.0.0.1:{srv.server_address[1]}/detect", bodies[0]))
    finally:
        srv.shutdown()
        srv.server_close()
        det.close()
    ref = aot16.detect_image(decoded[0])
    err = rows_err(np.asarray(ans["faces"], np.float64).reshape(-1, 15), ref)
    print(f"[app] (b) daemon over the artifact: {ans['count']} faces, AotDetector.detect_image {len(ref)}, "
          f"max abs err {err:.3e} px ({time.perf_counter() - t0:.1f} s for (b))")
    check(ans["count"] == len(ref) and err <= APP_DET_TOL, "daemon --exported == AotDetector.detect_image")

    # (d) int8: the bf16 flagship quantized on 8 seeded frames.
    t0 = time.perf_counter()
    p8 = Predictor(preset, state, pcfg, device=dev)
    calib_frames = [smooth_image(rng, 480, 640)[:, :, ::-1].copy() for _ in range(bsz)]
    n_sites = p8.quantize_int8(calib_frames)
    x_cal = torch.from_numpy(np.stack([I.serving_front_end(f, (size, size)) for f in calib_frames])).to(dev)
    site_err, n_checked = 0, 0

    def hold(module, args):
        nonlocal site_err, n_checked
        xq = module.quantize_input(args[0])
        a = Q.int8_conv_mm(xq, module.kernel_q, module.stride, module.padding, module.groups)
        b = Q.int8_conv_plain(xq, module.kernel_q, module.stride, module.padding, module.groups)
        site_err = max(site_err, int((a.long() - b.long()).abs().max()))
        n_checked += 1

    hooks = [m.register_forward_pre_hook(hold) for m in p8.model.modules() if isinstance(m, Q.QConv)]
    with torch.inference_mode():
        heads8 = p8.model(x_cal.permute(0, 3, 1, 2))
        heads16 = p16.model(x_cal.permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    cls_err = float((heads8[1].float() - heads16[1].float()).abs().mean())
    box_err = float((heads8[0].float() - heads16[0].float()).abs().mean())
    d8, v8 = driven("int8 Predictor", lambda: p8.detect_preprocessed(xb))
    x8d = torch.from_numpy(xb).to(dev)
    b2b = {tag: back_to_back_ms(lambda p=p: p._detect(x8d), iters=20) for tag, p in (("bf16", p16), ("int8", p8))}
    busy = {tag: device_ms(lambda p=p: p._detect(x8d), iters=5) for tag, p in (("bf16", p16), ("int8", p8))}
    print(f"[app] (d) int8 jabd_flagship {size}x{size}: {n_sites} sites quantized; int32 conv of the card's "
          f"_int_mm route against the float64 plain version at {n_checked} sites on the calibration batch: "
          f"max abs diff {site_err} (must be 0); heads against bf16: cls mean abs {cls_err:.4f} (bound 0.02), "
          f"box mean abs {box_err:.4f} (bound 0.05); valid dets {v8.sum(1).tolist()}")
    print(f"[app] (d) batch {bsz}: bf16 back-to-back {b2b['bf16']:.3f} ms/batch, device busy "
          f"{fmt_ms(busy['bf16'])}; int8 back-to-back {b2b['int8']:.3f} ms/batch, device busy "
          f"{fmt_ms(busy['int8'])} [{card}]")
    check(n_checked == n_sites and site_err == 0, "every quantized site's int32 output is bit-equal to the plain version")
    for tag, p in (("bf16", p16), ("int8", p8)):
        profile_rows(lambda p=p: p._detect(x8d), 5, "batch", card, f"(d) {tag} bs{bsz} {size}x{size}", phase="[app]")
    check(cls_err < 0.02 and box_err < 0.05, "int8 heads within the JAX package's bounds of bf16")
    art8 = os.path.join(tmp, "art8")
    aot.export_detector(p8, art8, batch_size=bsz)
    a8 = aot.load_exported(art8, device=dev)
    d8a, v8a = driven("int8 artifact", lambda: a8.detect_preprocessed(xb))
    err8 = float((d8a - d8).abs()[v8].max()) if bool(v8.any()) else 0.0
    print(f"[app] (d) int8 artifact: valid masks equal {bool(torch.equal(v8a, v8))}, max abs det err {err8:.3e} "
          f"({time.perf_counter() - t0:.1f} s for (d))")
    check(torch.equal(v8a, v8) and err8 <= APP_DET_TOL, "int8 artifact == live int8")

    # (e) cli train on PNGs with a label.txt, then predict from its checkpoint.
    t0 = time.perf_counter()
    tree = os.path.join(tmp, "train")
    label = write_label_tree(tree, wider_in_memory(APP_TRAIN_BATCH, APP_TRAIN_SIZE, seed=11))
    ckpt, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "logs")
    driven("cli train", lambda: run_cli(["train", "--model", "jabd_flagship", "--label-txt", label,
                                         "--batch-size", APP_TRAIN_BATCH, "--input-size", APP_TRAIN_SIZE,
                                         "--epochs", 1, "--freeze-epochs", 1, "--save-period", 1,
                                         "--ckpt-dir", ckpt, "--log-dir", logs, *dv]),
           kernel=matching_cuda.match_front, tag="K2")
    with open(os.path.join(logs, "metrics.csv")) as f:
        rows = f.read().splitlines()
    steps = sorted(os.listdir(ckpt))
    check(steps == ["1.pt"], f"cli train wrote the step checkpoint: {steps}")
    check(len(rows) == 2 and np.isfinite(float(rows[1].split(",")[2])), f"metrics.csv rows: {rows}")
    out = driven("cli predict --weights <ckpt-dir>", lambda: run_cli(
        ["predict", "--weights", ckpt, "--model", "jabd_flagship", "--input-size", size, "--image", fimg,
         "--confidence", 0.02, "--out", os.path.join(tmp, "drawn2.png"), *dv]))
    trained = torch.load(os.path.join(ckpt, "1.pt"), map_location="cpu", weights_only=True)["model"]
    n_tr = len(Predictor(preset, trained, dataclasses.replace(pcfg, confidence=0.02), device=dev).detect_image(frame))
    n_cli = int(out.split(" faces")[0].split()[-1])
    print(f"[app] (e) cli train jabd_flagship bs {APP_TRAIN_BATCH} {APP_TRAIN_SIZE}x{APP_TRAIN_SIZE} one epoch over "
          f"{APP_TRAIN_BATCH} PNGs: K2 launches {launches['cli train'][1]}, metrics.csv {rows[1:]}, checkpoint "
          f"{steps}; cli predict --weights <ckpt-dir>: {n_cli} faces, in-process {n_tr} "
          f"({time.perf_counter() - t0:.1f} s for (e))")
    check(n_cli == n_tr, "predict from the train checkpoint == in-process")

    # (f) count and fps.
    t0 = time.perf_counter()
    cnt = last_json(run_cli(["count", "--model", "jabd_flagship", "--size", size, "--per-layer", *dv]))
    cpu_params = count_params(build_model(preset, mode="eval", device="cpu"))
    rows = cnt["per_layer"]
    check(cnt["params"] == cpu_params, f"count params {cnt['params']} == the CPU model's {cpu_params}")
    check(sum(r["flops"] for r in rows[:-1]) == rows[-1]["flops"] and rows[-1]["flops"] > 0
          and sum(r["params"] for r in rows[:-1]) == rows[-1]["params"], "per-layer rows sum to TOTAL")
    fps = {}
    if dev.type == "cuda":
        for method in ("chained", "wall"):
            fps[method] = last_json(driven(f"cli fps {method}", lambda m=method: run_cli(
                ["fps", "--model", "jabd_flagship", "--input-size", size, "--image", fimg, "--iters", 30,
                 "--method", m, *dv])))["fps"]
    print(f"[app] (f) cli count jabd_flagship {size}: {cnt['params']} params (CPU model {cpu_params}), "
          f"{cnt['gflops']} conv/matmul GFLOPs, {len(rows) - 2} per-layer rows + (other) sum to TOTAL; "
          f"cli fps bf16 bs1 {size}x{size}: " + ", ".join(f"{m} {v:.1f} img/s" for m, v in fps.items())
          + f" ({time.perf_counter() - t0:.1f} s for (f)) [{card}]")

    k1_total = sum(n for tag, n in launches.values() if tag == "K1")
    k2_total = sum(n for tag, n in launches.values() if tag == "K2")
    print(f"[app] launches per path {launches}; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"k1": k1_total, "k2": k2_total}


# ---------------------------------------------------------------------------
# Phase 10: the recognition half
# ---------------------------------------------------------------------------

REC_GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "golden_recognition")
REC_ARCHES = ("ir_18", "ir_34", "ir_50", "ir_101", "ir_152", "ir_200",
              "ir_se_18", "ir_se_34", "ir_se_50", "ir_se_101", "ir_se_152", "ir_se_200")
REC_F32_ARCHES = ("ir_101", "ir_50")  # AdaFace's headline backbone, the CLI default
REC_EXTRACT_N, REC_EXTRACT_BS = 2048, 256
REC_DET_SIZE, REC_IMAGES, REC_EMBED_BATCH = 640, 4, 16
REC_SERVE_N = 8
REC_EXPORT_BS = 256
REC_VERIFY_PAIRS = 600
REC_PIPE_ARCH, REC_SERVE_ARCH = "ir_101", "ir_50"
# Card float32 (TF32 off) against the CPU, unit-norm embeddings: the max
# abs error and 1 - the smallest per-row cosine.
REC_F32_TOL, REC_COS_TOL = 1e-4, 1e-6


def seeded_ir_model(name: str, seed: int, dev, calib):
    """IR backbone `name` on `dev` with seeded random weights (a
    torch.Generator on `dev`): conv and fc weights N(0, 1/fan_in), fc bias
    N(0, 0.1^2), BatchNorm scale 1 + N(0, 0.1^2) and shift N(0, 0.1^2),
    PReLU alpha U(0.1, 0.4); then every BatchNorm's statistics set from its
    own input over the NCHW batch `calib` (features_bn's too), so the
    residual stream stays O(1) at 200 layers."""
    from jabd_tpu_torch.recognition import build_model
    from jabd_tpu_torch.recognition.net import PReLU

    g = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(name, device=dev)

    def randn(t):
        return torch.randn(t.shape, generator=g, device=dev)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.copy_(randn(m.weight) * m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * randn(m.bias))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * randn(m.weight))
                m.bias.copy_(0.1 * randn(m.bias))
            elif isinstance(m, PReLU):
                m.alpha.copy_(0.1 + 0.3 * torch.rand(m.alpha.shape, generator=g, device=dev))

    def take(m, args):
        x = args[0].float()
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        m.running_mean.copy_(x.mean(dims))
        m.running_var.copy_(x.var(dims, unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))]
    with torch.no_grad():
        model(calib)
    for h in hooks:
        h.remove()
    return model


def emb_errors(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, 1 - smallest per-row cosine) of [N, D] embeddings."""
    got, want = got.double().cpu(), want.double().cpu()
    cos = (got * want).sum(1) / (got.norm(dim=1) * want.norm(dim=1))
    return float((got - want).abs().max()), float(1 - cos.min())


def seeded_faces(rng, n: int, size: int = 112) -> np.ndarray:
    """[n, size, size, 3] uint8 smooth seeded 'faces' (BGR)."""
    return np.stack([smooth_image(rng, size, size) for _ in range(n)])


def write_ijbs_tree(root: str, rng) -> list:
    """A miniature IJB-S cs6 protocol directory in the shape of
    tests/test_lq_protocols.py's `ijbs_proto_tree` (6 subjects, 5 videos,
    UAV probes, split galleries), with every aligned crop written as a PNG
    under root/crops. Returns the crops' paths."""
    from PIL import Image

    g = os.path.join(root, "galleries")
    os.makedirs(g)
    pairs = [(1, "videos/100.mp4"), (2, "videos/100.mp4"), (3, "videos/101.mp4"), (4, "videos/102.mp4"),
             (5, "videos/103.mp4"), (6, "videos/104.mp4"), (2, "videos/105.mp4")]
    meta = ["subject_id,media"] + [f"{s},{v}" for s, v in pairs] + ["4,img/900.png"]
    files = {
        "cs6_metadata.csv": meta,
        "cs6_surveillance_to_single-booking_probe.csv": ["videos"] + [f"videos/10{i}.mp4" for i in range(5)],
        "cs6_surveillance_to_surveillance_probe.csv": ["videos"] + [f"videos/10{i}.mp4" for i in range(6)],
        "cs6_uav_to_single-booking_probe.csv": ["media", "videos/101.mp4", "img/900.png"],
    }

    def gallery(rows):
        return ["idx,subject_id,media"] + [f"{i},{s},{m}" for i, (s, m) in enumerate(rows)]

    files["galleries/cs6_surveillance_to_single_g1.csv"] = gallery([(s, f"img/s{s}.png") for s in (1, 2, 3)])
    files["galleries/cs6_surveillance_to_single_g2.csv"] = gallery([(s, f"img/s{s}.png") for s in (4, 5, 6)])
    files["galleries/cs6_surveillance_to_booking_g1.csv"] = gallery(
        [(s, f"img/b{s}_{k}.png") for s in (1, 2, 3) for k in (0, 1)])
    files["galleries/cs6_surveillance_to_booking_g2.csv"] = gallery(
        [(s, f"img/b{s}_{k}.png") for s in (4, 5, 6) for k in (0, 1)])
    files["galleries/cs6_surveillance_to_surveillance_g1.csv"] = gallery(
        [(s, v) for s, v in pairs if s <= 3 and v != "videos/105.mp4"])
    files["galleries/cs6_surveillance_to_surveillance_g2.csv"] = gallery([(s, v) for s, v in pairs if s > 3])
    for name, lines in files.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    names = [f"{s}/videos_{v.split('/')[1].split('.')[0]}_f{k}.png" for s, v in pairs for k in range(2)]
    names += [f"{s}/img_{n}.png" for s in range(1, 7) for n in (f"s{s}", f"b{s}_0", f"b{s}_1")]
    names.append("4/img_900.png")
    paths = []
    for n in names:
        p = os.path.join(root, "crops", n)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(smooth_image(rng, 112, 112)).save(p)
        paths.append(p)
    return paths


def write_tinyface_tree(root: str, rng, n_ids: int = 8) -> None:
    """A TinyFace layout: the two protocol .mat files (a cell array of
    (image name, subject id) rows each), probe, gallery and distractor
    PNGs."""
    import scipy.io as sio
    from PIL import Image

    align = os.path.join(root, "aligned_pad_0.1_pad_high")
    lists = {}
    for sub, tag in (("Probe", "p"), ("Gallery_Match", "g"), ("Gallery_Distractor", "d")):
        os.makedirs(os.path.join(align, sub))
        lists[sub] = [f"{i}_{tag}.png" for i in range(n_ids)]
        for n in lists[sub]:
            Image.fromarray(smooth_image(rng, 112, 112)).save(os.path.join(align, sub, n))
    mat_dir = os.path.join(root, "tinyface", "Testing_Set")
    os.makedirs(mat_dir)
    for key, sub, fname in (("probe_set", "Probe", "probe_img_ID_pairs.mat"),
                            ("gallery_set", "Gallery_Match", "gallery_match_img_ID_pairs.mat")):
        cell = np.empty((n_ids, 2), dtype=object)
        for i, n in enumerate(lists[sub]):
            cell[i] = n, float(i)
        sio.savemat(os.path.join(mat_dir, fname), {key: cell})


def write_lfw_bin(path: str, rng, n_pairs: int) -> None:
    """An insightface verification .bin: 2 * n_pairs PIL-written JPEGs of
    112x112 seeded faces and the issame list."""
    import pickle

    bins = [jpeg_bytes(smooth_image(rng, 112, 112)) for _ in range(2 * n_pairs)]
    with open(path, "wb") as f:
        pickle.dump((bins, [bool(b) for b in rng.random(n_pairs) < 0.5]), f)


def run_rcli(argv):
    """recognition.cli.main(argv) in this process; its standard output."""
    import contextlib
    import io

    from jabd_tpu_torch.recognition import cli as rcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcli.main([str(a) for a in argv])
    out = buf.getvalue()
    for line in out.splitlines()[-2:]:
        print(f"[recognition]   recognition.cli {argv[0]}: {line[:160]}")
    return out


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def recognition_phase(card, dev, preset, state):
    """Drive the recognition half (module docstring, phase 10). Returns K1's
    launches on these paths."""
    tmp = tempfile.mkdtemp(prefix="rec_")
    try:
        return _recognition_paths(card, dev, preset, state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _recognition_paths(card, dev, preset, state, tmp):
    import argparse
    import dataclasses
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    from jabd_tpu_torch import configs
    from jabd_tpu_torch.eval.run_wider import decode_bgr
    from jabd_tpu_torch.models import quantize as Q
    from jabd_tpu_torch.ops import nms_cuda
    from jabd_tpu_torch.pipeline import FacePipeline, Gallery, normalize_crops
    from jabd_tpu_torch.predict import Predictor
    from jabd_tpu_torch.recognition import build_model
    from jabd_tpu_torch.recognition import cli as rcli
    from jabd_tpu_torch.recognition.align import (
        ARCFACE_TEMPLATE,
        align_face,
        align_from_detections,
        landmarks_from_detection,
        similarity_transform,
    )
    from jabd_tpu_torch.recognition.fold import fold_ir
    from jabd_tpu_torch.recognition.train import extract_embeddings_tta
    from jabd_tpu_torch.serve import BatchingDetector, IdentityService, make_server

    k1 = nms_cuda.nms_keep_sorted
    launches = {}
    t_phase = time.perf_counter()
    dv = ["--device", dev.type]
    rng = np.random.default_rng(12)

    def driven(name, fn):
        reset_counts()
        out = fn()
        sync(dev)
        launches[name] = k1.launches
        check(k1.launches > 0, f"{name} launched K1")
        return out

    def nchw(x_u8):
        return torch.from_numpy(normalize_crops(x_u8)).permute(0, 3, 1, 2).to(dev)

    # (a) The golden fixture: align, then ir_18 at float32 (TF32 off).
    t0 = time.perf_counter()
    golden = dict(np.load(os.path.join(REC_GOLDEN_DIR, "golden.npz")))
    crops, n_diff = [], 0
    for stem in ("scene_0", "scene_1"):
        scene = read_png(os.path.join(REC_GOLDEN_DIR, stem + ".png"))
        crop = align_face(scene, golden[f"landmarks_{stem}"])
        n_diff += int((crop != golden[f"crop_{stem}"]).sum())
        crops.append(crop)
    crops = np.stack(crops)
    gmodel = build_model("ir_18", device="cpu")
    gmodel.load_state_dict(golden_ir_state_dict("ir_18"))
    g64 = build_model("ir_18", dtype=torch.float64, device="cpu")
    g64.load_state_dict(gmodel.state_dict())
    gemb = FacePipeline(None, gmodel.to(dev), device=dev).embed_crops(crops)
    with torch.no_grad():
        e64 = g64(torch.from_numpy(normalize_crops(crops)).double().permute(0, 3, 1, 2))[0].numpy()
    err = float(np.abs(gemb - golden["embeddings"]).max())
    n = gemb / np.linalg.norm(gemb, axis=1, keepdims=True)
    cos_err = abs(float(n[0] @ n[1]) - float(golden["cosine_01"]))
    print(f"[recognition] (a) golden fixture: crops aligned by the port differ from golden.npz in {n_diff} of "
          f"{crops.size} values; ir_18 f32 (TF32 off) embeddings max abs err {err:.3e} against golden.npz "
          f"(bound 1e-4), cosine_01 err {cos_err:.3e} (bound 1e-4); against the port's float64 forward on the "
          f"CPU: card {np.abs(gemb - e64).max():.3e}, golden.npz {np.abs(golden['embeddings'] - e64).max():.3e} "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    check(n_diff == 0, "the port's golden crops are byte-equal to golden.npz")
    check(err <= 1e-4 and cos_err <= 1e-4, "golden embeddings within 1e-4")

    # (b) Every IR name at full width: bf16 finite and unit-norm; ir_101 and
    # ir_50 at float32 on the card against the port on the CPU.
    t0 = time.perf_counter()
    calib = nchw(seeded_faces(rng, 16))
    x2 = calib[:2]
    models = {}
    for name in REC_ARCHES:
        model = seeded_ir_model(name, seed=REC_ARCHES.index(name), dev=dev, calib=calib)
        if name in REC_F32_ARCHES:
            cpu = build_model(name, device="cpu")
            cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            with torch.no_grad():
                got, want = model(x2)[0], cpu(x2.cpu())[0]
            abs_err, cos_err = emb_errors(got, want)
            print(f"[recognition] (b) {name} f32 (TF32 off) bs 2 card vs CPU: max abs err {abs_err:.3e} "
                  f"(bound {REC_F32_TOL}), 1 - min cosine {cos_err:.3e} (bound {REC_COS_TOL}) [{card}]")
            check(abs_err <= REC_F32_TOL and cos_err <= REC_COS_TOL, f"{name} card f32 == CPU f32")
            models[name] = model
        b16 = fold_ir(copy.deepcopy(model)).to(torch.bfloat16)
        with torch.no_grad():
            e16, n16 = b16(x2)
        nrm = e16.norm(dim=1)
        params = sum(p.numel() for p in model.parameters())
        print(f"[recognition] (b) {name}: {params} params, bf16 folded bs 2: finite "
              f"{bool(torch.isfinite(e16).all())}, |emb| {nrm.tolist()}, norms {n16.flatten().tolist()}")
        check(bool(torch.isfinite(e16).all()) and float((nrm - 1).abs().max()) < 1e-3,
              f"{name} bf16 embeddings finite and unit-norm")
        del b16
        if name not in REC_F32_ARCHES:
            del model
    print(f"[recognition] (b) {len(REC_ARCHES)} IR names built and run in {time.perf_counter() - t0:.1f} s")

    # (c) Extraction: ir_101 flip-TTA over REC_EXTRACT_N seeded crops.
    t0 = time.perf_counter()
    ext = models[REC_PIPE_ARCH]
    faces = normalize_crops(seeded_faces(rng, REC_EXTRACT_N))
    ext16 = fold_ir(copy.deepcopy(ext)).to(torch.bfloat16)
    feats = {}
    for tag, m in (("f32", ext), ("bf16", ext16)):
        extract_embeddings_tta(m, faces[:REC_EXTRACT_BS], REC_EXTRACT_BS, device=dev)  # warm-up
        sync(dev)
        t1 = time.perf_counter()
        feats[tag] = extract_embeddings_tta(m, faces, REC_EXTRACT_BS, device=dev)[0]
        sync(dev)
        wall = time.perf_counter() - t1
        print(f"[recognition] (c) extract_embeddings_tta {REC_PIPE_ARCH} {tag} bs {REC_EXTRACT_BS} flip TTA over "
              f"{REC_EXTRACT_N} crops: {wall:.3f} s, {REC_EXTRACT_N / wall:.1f} img/s "
              f"({2 * REC_EXTRACT_N / wall:.1f} forward img/s), host clock [{card}]")
        xb = torch.from_numpy(faces[:REC_EXTRACT_BS]).to(dev).permute(0, 3, 1, 2)
        if dev.type == "cuda":
            profile_rows(lambda m=m, xb=xb: (m(xb), m(torch.flip(xb, dims=(3,)))), 3, "batch", card,
                         f"(c) {REC_PIPE_ARCH} {tag} bs {REC_EXTRACT_BS} + flip", phase="[recognition]")
    abs_err, cos_err = emb_errors(torch.from_numpy(feats["bf16"]), torch.from_numpy(feats["f32"]))
    print(f"[recognition] (c) bf16 against f32 fused features: max abs err {abs_err:.3e}, 1 - min cosine "
          f"{cos_err:.3e} ({time.perf_counter() - t0:.1f} s for (c))")
    check(np.isfinite(feats["bf16"]).all() and cos_err < 0.02, "bf16 extraction close to f32")
    del ext16

    # (d) The pipeline: flagship bf16 detector, folded ir_101 bf16 embedder.
    t0 = time.perf_counter()
    pcfg = configs.PredictConfig(confidence=0.02, input_shape=(REC_DET_SIZE, REC_DET_SIZE))
    p16 = Predictor(preset, state, pcfg, device=dev)
    emb16 = fold_ir(copy.deepcopy(ext)).to(torch.bfloat16)
    pipe = FacePipeline(p16, emb16, embed_batch=REC_EMBED_BATCH, device=dev)
    images = [img[:, :, ::-1].copy() for img in wider_in_memory(REC_IMAGES, REC_DET_SIZE, seed=13).images]
    pipe.analyze(images[0])  # warm-up
    results = [driven(f"analyze image {i}", lambda im=im: pipe.analyze(im)) for i, im in enumerate(images)]
    split = collections.defaultdict(float)
    worst, n_crops, crop_diff, norm_diff, cv2_diff, cv2_max = 0.0, 0, 0, 0, 0, 0
    try:  # OpenCV's warp, the JAX package's, timed as a reference the port never calls
        import cv2
    except ImportError:
        cv2 = None
    for im, (dets, embs) in zip(images, results):
        sync(dev)
        t1 = time.perf_counter()
        d = p16.detect_image(im)
        t2 = time.perf_counter()
        c = align_from_detections(im, d, device=dev)
        sync(dev)
        t3 = time.perf_counter()
        pipe.embed_crops(c)
        t4 = time.perf_counter()
        host = align_from_detections(im, d)
        t5 = time.perf_counter()
        split["detect"] += (t2 - t1) * 1000 / len(images)
        split["align"] += (t3 - t2) * 1000 / len(images)
        split["embed"] += (t4 - t3) * 1000 / len(images)
        split["host align"] += (t5 - t4) * 1000 / len(images)
        check(d.shape == dets.shape and embs.shape == (len(dets), 512) and np.isfinite(embs).all(),
              "analyze: [N, 15] dets and finite [N, 512] embeddings")
        n_crops += len(d)
        crop_diff += int((c.cpu().numpy() != host).sum())
        norm_diff += int((normalize_crops(c).cpu().numpy() != normalize_crops(host)).sum())
        worst = max(worst, float(np.abs(pipe.embed_crops(host) - embs).max(initial=0.0))
                    if d.shape == dets.shape else np.inf)
        if cv2 is not None and len(d):
            mats = [similarity_transform(landmarks_from_detection(r), ARCFACE_TEMPLATE) for r in d]
            t6 = time.perf_counter()
            ref = np.stack([cv2.warpAffine(im, m, (112, 112), flags=cv2.INTER_LINEAR, borderValue=0)
                            for m in mats])
            split["cv2 align"] += (time.perf_counter() - t6) * 1000 / len(images)
            cv2_diff += int((ref != host).sum())
            cv2_max = max(cv2_max, int(np.abs(ref.astype(np.int16) - host).max()))
    ref_line = (f"cv2 {cv2.__version__} warpAffine of the same matrices ({cv2.getNumThreads()} threads, a "
                f"reference the port never calls) {split['cv2 align']:.1f} ms, {cv2_diff} crop values differ "
                f"(max {cv2_max} grey levels)"
                if cv2 is not None else "cv2 not installed: its warp not measured")
    print(f"[recognition] (d) analyze flagship bf16 {REC_DET_SIZE}x{REC_DET_SIZE} conf 0.02 + folded "
          f"{REC_PIPE_ARCH} bf16 embed_batch {REC_EMBED_BATCH}, {REC_IMAGES} WIDER-geometry images: faces "
          f"{[len(r[0]) for r in results]}, K1 launches {[launches[f'analyze image {i}'] for i in range(REC_IMAGES)]}; "
          f"crops warped on the card against the CPU warp: {crop_diff} of {n_crops * 112 * 112 * 3} values "
          f"differ, normalized {norm_diff}; embeddings against embed_crops on host-aligned crops max abs err "
          f"{worst:.3e}; ms per image, host clock: detect {split['detect']:.1f}, align on the card "
          f"{split['align']:.1f}, embed {split['embed']:.1f}; the same warp on the CPU {split['host align']:.1f}, "
          f"{ref_line} [{card}]")
    check(crop_diff == 0 and norm_diff == 0, "crops warped and normalized on the card == on the CPU, bytewise")
    check(worst <= 1e-6, "analyze embeddings == embed_crops of the host-aligned crops")
    gallery = Gallery()
    dets0, embs0 = results[0]
    names = [f"person{i}" for i in range(min(3, len(embs0)))]
    for name, e in zip(names, embs0):
        gallery.enroll(name, e)
    matches = gallery.match(embs0[: len(names)], threshold=0.3)
    npz = os.path.join(tmp, "gallery.npz")
    gallery.save(npz)
    back = Gallery.load(npz)
    check([m[0] for m in matches] == names and all(abs(m[1] - 1) < 1e-5 for m in matches),
          "each enrolled face matches its own name at cosine 1")
    check(back.names == names and np.array_equal(back.matrix, gallery.matrix)
          and back.match(embs0) == gallery.match(embs0), "gallery npz round trip")
    print(f"[recognition] (d) gallery of {len(names)}: matches {matches}; npz round trip equal "
          f"({time.perf_counter() - t0:.1f} s for (d))")
    del emb16, pipe

    # (e) POST /identify over the float32 flagship (TF32 off) and folded ir_50.
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(preset, compute_dtype="float32")
    pcfg05 = configs.PredictConfig(confidence=0.5, input_shape=(REC_DET_SIZE, REC_DET_SIZE))
    p32 = Predictor(cfg32, state, pcfg05, device=dev)
    ir50 = fold_ir(copy.deepcopy(models[REC_SERVE_ARCH]))
    identity = IdentityService(FacePipeline(None, ir50, device=dev), gallery=gallery, threshold=0.3)
    served = []  # (image, detections) of each request, as the handler threads met them
    analyze = identity.analyze
    identity.analyze = lambda image, dets: served.append((image, dets)) or analyze(image, dets)
    frames = [smooth_image(rng, int(h), int(w))[:, :, ::-1].copy()
              for h, w in zip(rng.integers(360, 720, REC_SERVE_N), rng.integers(480, 960, REC_SERVE_N))]
    bodies = [jpeg_bytes(f) for f in frames]
    decoded = [decode_bgr(b) for b in bodies]
    det = BatchingDetector(p32, batch_size=4, max_wait_ms=50.0)
    srv = make_server(det, "127.0.0.1", 0, identity=identity)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        post(url + "/identify", bodies[0])  # warm-up
        before = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
        served.clear()

        def burst():
            with ThreadPoolExecutor(REC_SERVE_N) as pool:
                return list(pool.map(lambda b: post(url + "/identify", b), bodies))

        t1 = time.perf_counter()
        answers = driven("daemon POST /identify", burst)
        wall = time.perf_counter() - t1
        stats = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
    finally:
        srv.shutdown()
        srv.server_close()
        det.close()
    identity.analyze = analyze
    n_req, n_batches = stats["requests"] - before["requests"], stats["batches"] - before["batches"]
    # Detections: the daemon's batches against detect_image one at a time.
    # Faces: each answer against analyze() in this process on the very
    # detections the handler aligned.
    box_err = emb_err = 0.0
    check(len(served) == REC_SERVE_N, "every /identify request reached IdentityService")
    for ans, img in zip(answers, decoded):
        dets = next(d for im, d in served if im.shape == img.shape and np.array_equal(im, img))
        box_err = max(box_err, rows_err(dets, p32.detect_image(img)))
        want = identity.analyze(img, dets)
        check(ans["count"] == len(want) == len(dets), f"/identify answer has {ans['count']} faces, in-process {len(want)}")
        for f, w in zip(ans["faces"], want):
            check(f["box"] == w["box"] and f["name"] == w["name"], "/identify boxes and names == in-process")
            emb_err = max(emb_err, float(np.abs(np.asarray(f["embedding"]) - w["embedding"]).max()))
    det0 = BatchingDetector(p32, batch_size=4)
    srv0 = make_server(det0, "127.0.0.1", 0)
    threading.Thread(target=srv0.serve_forever, daemon=True).start()
    try:
        post(f"http://127.0.0.1:{srv0.server_address[1]}/identify", bodies[0])
        code = 200
    except urllib.error.HTTPError as e:
        code = e.code
    finally:
        srv0.shutdown()
        srv0.server_close()
        det0.close()
    print(f"[recognition] (e) daemon POST /identify f32 flagship {REC_DET_SIZE}x{REC_DET_SIZE} conf 0.5 batch 4 + "
          f"folded {REC_SERVE_ARCH} f32: {REC_SERVE_N} concurrent JPEG POSTs in {wall * 1000:.1f} ms (host clock), "
          f"faces {[a['count'] for a in answers]}, healthz +{n_req} requests in +{n_batches} batches, K1 launches "
          f"{launches['daemon POST /identify']}; the daemon's detections against detect_image max abs err "
          f"{box_err:.3e} px (bound {APP_DET_TOL}); its faces against IdentityService.analyze in this process on "
          f"the same detections: embeddings max abs err {emb_err:.3e} (bound 1e-5); without an embedder "
          f"/identify answers {code} ({time.perf_counter() - t0:.1f} s for (e)) [{card}]")
    check(box_err <= APP_DET_TOL and emb_err <= 1e-5, "/identify answers == in-process IdentityService")
    check(n_req == REC_SERVE_N and launches["daemon POST /identify"] >= n_batches, "K1 per batch, healthz counts")
    check(code == 503, "/identify without an embedder answers 503")

    # (f) The CLIs.
    t0 = time.perf_counter()
    from jabd_tpu_torch.utils.torch_convert import export_state_dict_auto, save_pth

    fpth = os.path.join(tmp, "flagship.pth")
    save_pth(export_state_dict_auto(state, preset), fpth)
    ir50_pt = os.path.join(tmp, "ir50.pt")
    torch.save({k: v.cpu() for k, v in models[REC_SERVE_ARCH].state_dict().items()}, ir50_pt)
    gal_dir = os.path.join(tmp, "people")
    for p, name in enumerate(("ann", "bob")):
        os.makedirs(os.path.join(gal_dir, name))
        for k in range(2):
            Image.fromarray(smooth_image(rng, 480, 640)).save(os.path.join(gal_dir, name, f"{k}.jpg"), quality=92)
    probe = os.path.join(gal_dir, "ann", "0.jpg")
    npz = os.path.join(tmp, "people.npz")
    base = ["identify", "--weights", fpth, "--input-size", REC_DET_SIZE, "--confidence", 0.02, "--arch",
            REC_SERVE_ARCH, "--ckpt", ir50_pt, "--image", probe, "--gallery", npz, *dv]
    out1 = driven("cli identify --gallery-dir", lambda: run_cli(base + ["--gallery-dir", gal_dir,
                                                                        "--out", os.path.join(tmp, "id.png")]))
    out2 = driven("cli identify --gallery npz", lambda: run_cli(base))
    rows1 = [json.loads(ln) for ln in out1.splitlines() if ln.startswith("{")]
    rows2 = [json.loads(ln) for ln in out2.splitlines() if ln.startswith("{")]
    check(rows1 == rows2 and len(rows1) > 0, "cli identify from the saved npz == the enrolling run")
    check(Gallery.load(npz).names == ["ann", "bob"] and os.path.exists(os.path.join(tmp, "id.png")),
          "cli identify wrote the gallery npz and the drawing")
    named = sum(r["name"] == "ann" for r in rows1)
    print(f"[recognition] (f) cli identify flagship bf16 {REC_DET_SIZE} + {REC_SERVE_ARCH} (--ckpt a port state "
          f"dict): {len(rows1)} faces, {named} named ann; K1 launches {launches['cli identify --gallery-dir']} "
          f"(enrol + identify), {launches['cli identify --gallery npz']} (from the npz)")

    art = os.path.join(tmp, "emb_art")
    run_rcli(["export", "--arch", REC_SERVE_ARCH, "--ckpt", ir50_pt, "--fold", "--batch-size", REC_EXPORT_BS,
              "--platforms", dev.type, "--out", art, *dv])
    xb = normalize_crops(seeded_faces(rng, REC_EXPORT_BS))
    np.save(os.path.join(tmp, "xb.npy"), xb)
    code = (
        "import json, sys, numpy as np, torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
        "from jabd_tpu_torch import aot\n"
        f"a = aot.load_exported({art!r}, device={dev.type!r})\n"
        f"e, n = a.embed(np.load({os.path.join(tmp, 'xb.npy')!r}))\n"
        f"np.save({os.path.join(tmp, 'emb.npy')!r}, e.cpu().numpy())\n"
        "print(json.dumps({'model_code': sorted(m for m in sys.modules if m.startswith(\n"
        "    ('jabd_tpu_torch.recognition', 'jabd_tpu_torch.models', 'jabd_tpu_torch.predict')))}))\n"
    )
    sub = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(sub.returncode == 0, f"fresh-interpreter embedder load: {sub.stderr[-800:]}")
    fresh = last_json(sub.stdout)
    live = rcli._load_backbone(argparse.Namespace(arch=REC_SERVE_ARCH, ckpt=ir50_pt, fold=True, quantize="none",
                                                  device=dev.type))
    with torch.no_grad():
        want = live(torch.from_numpy(xb).to(dev).permute(0, 3, 1, 2))[0]
    aerr, acos = emb_errors(torch.from_numpy(np.load(os.path.join(tmp, "emb.npy"))), want)
    print(f"[recognition] (f) recognition.cli export folded {REC_SERVE_ARCH} bs {REC_EXPORT_BS}: fresh interpreter "
          f"(aot.py only) imported model code {fresh['model_code']}; against the live model max abs err "
          f"{aerr:.3e}, 1 - min cosine {acos:.3e} (bounds 1e-5, 1e-6)")
    check(not fresh["model_code"] and aerr <= 1e-5 and acos <= 1e-6, "embedder artifact == live model")

    # int8 calibrated on the batch it is held on (the JAX package's test
    # recipe); the CLI's self-calibration on noise is reported beside it.
    x_eval = torch.from_numpy(xb[:16]).to(dev).permute(0, 3, 1, 2)
    q8 = copy.deepcopy(live)
    Q.quantize_model(q8, Q.calibrate(q8, [x_eval]))
    q8cli = rcli._load_backbone(argparse.Namespace(arch=REC_SERVE_ARCH, ckpt=ir50_pt, fold=True, quantize="int8",
                                                   quantize_search=False, device=dev.type))
    site_err, n_checked = 0, 0

    def hold(module, args):
        nonlocal site_err, n_checked
        xq = module.quantize_input(args[0])
        if isinstance(module, Q.QDense):
            a, b = Q.int8_matmul_mm(xq, module.kernel_q), Q.int8_matmul_plain(xq, module.kernel_q)
        else:
            a = Q.int8_conv_mm(xq, module.kernel_q, module.stride, module.padding, module.groups)
            b = Q.int8_conv_plain(xq, module.kernel_q, module.stride, module.padding, module.groups)
        site_err = max(site_err, int((a.long() - b.long()).abs().max()))
        n_checked += 1

    sites = [m for m in q8.modules() if isinstance(m, (Q.QConv, Q.QDense))]
    hooks = [m.register_forward_pre_hook(hold) for m in sites]
    with torch.no_grad():
        e8 = q8(x_eval)[0]
    for h in hooks:
        h.remove()
    with torch.no_grad():
        e32 = live(x_eval)[0]
        e8cli = q8cli(x_eval)[0]
    cos8 = float(((e8.double() * e32.double()).sum(1)).min())
    cos8cli = float(((e8cli.double() * e32.double()).sum(1)).min())
    b16 = copy.deepcopy(live).to(torch.bfloat16)
    xbig = torch.from_numpy(xb).to(dev).permute(0, 3, 1, 2)
    times = {}
    if dev.type == "cuda":
        times = {tag: back_to_back_ms(lambda m=m: m(xbig), iters=10) for tag, m in (("bf16", b16), ("int8", q8))}
    print(f"[recognition] (f) --embed-quantize int8 {REC_SERVE_ARCH}: {len(sites)} sites (fc a QDense: "
          f"{isinstance(q8.fc, Q.QDense)}); _int_mm int32 against the float64 plain version at {n_checked} sites: "
          f"max abs diff {site_err} (must be 0); min cosine to the folded f32 model {cos8:.5f} (bound 0.98; "
          f"self-calibrated on noise as the CLI does: {cos8cli:.5f}); "
          f"bs {REC_EXPORT_BS} back-to-back ms/batch {times} [{card}]")
    check(n_checked == len(sites) and site_err == 0 and isinstance(q8.fc, Q.QDense),
          "every int8 site's _int_mm int32 output is bit-equal to the plain version")
    check(cos8 > 0.98, "int8 embeddings within the JAX package's cosine bound")
    out = driven("cli identify --embed-quantize int8", lambda: run_cli(base + ["--embed-quantize", "int8"]))
    check(len([ln for ln in out.splitlines() if ln.startswith("{")]) == len(rows1), "int8 identify: same faces")
    del q8, q8cli, b16, live

    vdir = os.path.join(tmp, "val")
    os.makedirs(vdir)
    write_lfw_bin(os.path.join(vdir, "lfw.bin"), rng, REC_VERIFY_PAIRS)
    ver = last_json(run_rcli(["verify", "--arch", REC_SERVE_ARCH, "--ckpt", ir50_pt, "--data-dir", vdir, *dv]))
    check(sorted(ver) == ["lfw", "mean"] and 0.0 <= ver["lfw"]["val_acc"] <= 1.0, "verify accuracy in [0, 1]")
    tf_root = os.path.join(tmp, "tinyface")
    write_tinyface_tree(tf_root, rng)
    tf = last_json(run_rcli(["tinyface", "--arch", REC_SERVE_ARCH, "--ckpt", ir50_pt, "--batch-size", 16,
                             "--tinyface-root", tf_root, *dv]))
    check(sorted(tf) == ["rank_1", "rank_20", "rank_5"] and all(0 <= v <= 1 for v in tf.values()), "tinyface ranks")
    ij_root = os.path.join(tmp, "ijbs")
    crop_paths = write_ijbs_tree(ij_root, rng)
    lst = os.path.join(tmp, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(crop_paths) + "\n")
    feats_dir = os.path.join(tmp, "feats")
    run_rcli(["extract", "--arch", REC_SERVE_ARCH, "--ckpt", ir50_pt, "--batch-size", 16, "--image-list", lst,
              "--out-dir", feats_dir, "--partitions", 4, *dv])
    parts = sorted(n for n in os.listdir(feats_dir) if n.startswith("features_part"))
    ij = json.loads(run_rcli(["ijbs", "--features", os.path.join(feats_dir, "features.npz"),
                              "--protocol-dir", ij_root]))
    check(len(parts) == 4 and len(ij) == 5 and all(0 <= v["rank1"] <= 1 for v in ij.values()), "extract + ijbs")
    print(f"[recognition] (f) recognition.cli verify ({REC_VERIFY_PAIRS} pairs of PIL-written JPEGs) {ver}; "
          f"tinyface {tf}; extract {len(crop_paths)} crops in {parts}; ijbs rank1 "
          f"{ {k: v['rank1'] for k, v in ij.items()} } ({time.perf_counter() - t0:.1f} s for (f))")

    k1_total = sum(launches.values())
    print(f"[recognition] K1 launches per path {launches}; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"launches": k1_total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import dataclasses

    from jabd_tpu_torch import _build, configs
    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.models.fold import fold_batchnorm
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import nms as N
    from jabd_tpu_torch.ops import nms_cuda
    from jabd_tpu_torch.predict import Predictor, postprocess_outputs, select_candidates
    from jabd_tpu_torch.serve import BatchingDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 0: card and build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        print_ptxas(name, log)

    # -- phase 1: kernel against plain ---------------------------------------
    worst = nms_phase(dev, nms_cuda._library().jabd_nms_max_k())

    # -- phase 2: the slice on the main path ---------------------------------
    preset = configs.get_model_config("jabd_flagship")
    cfg32 = dataclasses.replace(preset, compute_dtype="float32")
    pcfg = configs.PredictConfig(confidence=0.02, input_shape=(640, 640))
    state = seeded_state_dict(preset, seed=0)
    p32 = Predictor(cfg32, state, pcfg, device="cuda")
    p16 = Predictor(preset, state, pcfg, device="cuda")
    rng = np.random.default_rng(0)
    batch8 = rng.normal(0, 50, (8, 640, 640, 3)).astype(np.float32)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((480, 640), (720, 1280), (333, 517))]
    requests = [rng.integers(0, 256, (400 + 40 * i, 600 - 30 * i, 3), dtype=np.uint8)
                for i in range(8)]
    torch.cuda.synchronize()

    counter = nms_cuda.nms_keep_sorted
    reset_counts()
    per_path = {}

    def counted(name, fn):
        before = counter.launches
        out = fn()
        torch.cuda.synchronize()
        per_path[name] = counter.launches - before
        return out

    dets32, valid32 = counted("detect_preprocessed f32", lambda: p32.detect_preprocessed(batch8))
    dets16, valid16 = counted("detect_preprocessed bf16", lambda: p16.detect_preprocessed(batch8))
    img_dets = counted("detect_image bf16", lambda: [p16.detect_image(im) for im in images])
    server = BatchingDetector(p16, batch_size=4, max_wait_ms=50.0)

    def serve_all():
        with ThreadPoolExecutor(max_workers=4) as pool:
            return list(pool.map(server.detect, requests))

    served = counted("BatchingDetector bf16", serve_all)
    stats = server.stats()
    server.close()
    main_launches = counter.launches
    print(f"[phase2] launches per path {per_path}; server {stats}")
    for name, n in per_path.items():
        check(n > 0, f"{name} launched the NMS kernel")
    check(len(served) == len(requests) and stats["requests"] == len(requests),
          "every request answered")
    check(not server._worker.is_alive(), "server thread stopped")
    for d in served + img_dets:
        check(d.ndim == 2 and d.shape[1] == 15 and np.isfinite(d).all(), "pixel dets finite [N, 15]")
    for dets, valid in ((dets32, valid32), (dets16, valid16)):
        check(tuple(dets.shape) == (8, 750, 15) and tuple(valid.shape) == (8, 750), "det shapes")
        check(bool(torch.isfinite(dets).all()), "dets finite")
    print(f"[phase2] valid dets per image f32 {valid32.sum(1).tolist()} "
          f"bf16 {valid16.sum(1).tolist()}; detect_image counts "
          f"{[len(d) for d in img_dets]}; served counts {[len(d) for d in served]}")

    # Plain NMS on the same head outputs gives identical detections.
    anchors = torch.from_numpy(A.generate_anchors(preset.anchors, (640, 640)).copy()).to(dev)
    x8 = torch.from_numpy(batch8).to(dev).permute(0, 3, 1, 2)
    var = preset.anchors.variance
    kernel_inputs = {}
    for tag, p in (("f32", p32), ("bf16", p16)):
        with torch.inference_mode():
            heads = p.model(x8)
            d_k, v_k = postprocess_outputs(*heads, anchors, pcfg, var)
            d_p, v_p = postprocess_outputs(*heads, anchors, pcfg, var, keep_fn=N.nms_keep_sorted)
            cand_boxes, _, cand_valid, _ = select_candidates(*heads, anchors, pcfg, var)
        torch.cuda.synchronize()
        check(torch.equal(v_k, v_p) and torch.equal(d_k, d_p), f"{tag}: kernel dets == plain dets")
        kernel_inputs[tag] = (cand_boxes.contiguous(), cand_valid.contiguous())
        print(f"[phase2] {tag}: kernel and plain NMS give identical detections; "
              f"n_valid per image {cand_valid.sum(1).tolist()}")

    # Float32 heads on the card against the port on the CPU (640x640, bs 1).
    cpu_model = build_model(cfg32, mode="eval", device="cpu")
    cpu_model.load_state_dict(state)
    fold_batchnorm(cpu_model.eval())
    x1 = torch.from_numpy(batch8[:1]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ref = cpu_model(x1)
        got = p32.model(x1.to(dev))
        got16 = p16.model(x1.to(dev))
    for name, r, g, h in zip(("loc", "cls", "landm"), ref, got, got16):
        err = float((g.cpu() - r).abs().max())
        scale = max(1.0, float(r.abs().max()))
        err16 = float((h.float().cpu() - r).abs().max())
        print(f"[phase2] {name}: card f32 vs CPU f32 max abs err {err:.3e} "
              f"(max |ref| {scale:.3e}); card bf16 vs CPU f32 {err16:.3e}")
        check(err <= 1e-3 * scale, f"{name} card f32 matches CPU f32 within 1e-3 * max|ref|")
        check(bool(torch.isfinite(h).all()), f"{name} bf16 finite")

    # Timings, each tagged with the card. "back-to-back": CUDA events
    # around 30 batches enqueued without a wait (host enqueue overlaps the
    # card); "host->host": numpy batch in, detections back on the host,
    # one batch at a time.
    for tag, p in (("f32", p32), ("bf16", p16)):
        fps1 = p.get_fps(images[0], test_interval=50)
        print(f"[time] {tag} bs1 Predictor.get_fps: {1000 / fps1:.3f} ms/batch, "
              f"{fps1:.1f} img/s [{card}]")
        for bs in (1, 8):
            xb = torch.from_numpy(batch8[:bs]).to(dev)
            ms_b2b = back_to_back_ms(lambda: p._detect(xb), iters=30)

            def e2e():
                d, v = p.detect_preprocessed(batch8[:bs])
                return d.cpu(), v.cpu()

            e2e()
            t0 = time.perf_counter()
            n = 20
            for _ in range(n):
                e2e()
            ms_e2e = (time.perf_counter() - t0) * 1000 / n
            print(f"[time] {tag} bs{bs}: back-to-back {ms_b2b:.3f} ms/batch "
                  f"({1000 * bs / ms_b2b:.1f} img/s); host->host "
                  f"{ms_e2e:.3f} ms/batch ({1000 * bs / ms_e2e:.1f} img/s) [{card}]")

    # Where the time goes: device kernel time by name over 5 bf16 bs-8
    # batches (torch.profiler, CUPTI), against the wall clock.
    x8d = torch.from_numpy(batch8).to(dev)
    p16._detect(x8d)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            p16._detect(x8d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / 5
    # Kernel rows only: an aten op's own row repeats its kernels' time.
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1000 / 5
    launches = sum(e.count for e in rows) / 5
    print(f"[profile] bf16 bs8 under the profiler: wall {wall_ms:.3f} ms/batch, device busy "
          f"{busy_ms:.3f} ms/batch, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{launches:.0f} kernels/batch [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1000 / 5:8.3f} ms/batch "
              f"{e.count // 5:5d}x {e.key[:90]}")

    # Kernel time on the main path's own candidates (bf16 preset, bs 8).
    kb, kv = kernel_inputs["bf16"]
    kind, thr = pcfg.nms_kind, pcfg.nms_iou
    ms = cuda_ms(lambda: nms_cuda.nms_keep_sorted(kb, kv, thr, kind), iters=30)
    split = device_split(lambda: nms_cuda.nms_keep_sorted(kb, kv, thr, kind))
    dev_ms = sum(split.values()) if split else None
    plain_ms = cuda_ms(lambda: N.nms_keep_sorted(kb, kv, thr, kind), iters=3, warmup=1)
    keep_plain = N.nms_keep_sorted(kb, kv, thr, kind)
    keep_kernel = nms_cuda.nms_keep_sorted(kb, kv, thr, kind)
    err = float((keep_kernel.float() - keep_plain.float()).abs().max())
    check(err == 0.0, "kernel == plain on the main path's candidates")
    worst = max(worst, err)
    b, k = kv.shape
    nbytes = b * k * (16 + 1) + b * k  # boxes + valid in, keep out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nms_ops(kv, keep_plain, kind) / F32_FLOPS * 1e3
    print(f"[phase3] nms_keep_sorted B={b} K={k}: kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), "
          f"plain {plain_ms:.3f} ms, "
          f"bytes bound {bytes_ms:.6f} ms, operations bound {ops_ms:.6f} ms, "
          f"kept per image {keep_plain.sum(1).tolist()} [{card}]")
    for name, t in split.items():
        print(f"[phase3]   device {t:.4f} ms {name[:80]}")

    # Lighter loads: the same candidates with the valid rows cut to a prefix.
    for n in (50, 500, 5000):
        kv_n = (kv & (torch.arange(k, device=dev) < n)).contiguous()
        keep_n = nms_cuda.nms_keep_sorted(kb, kv_n, thr, kind)
        if n < 5000:  # 5000 is the full main path, checked above
            check(torch.equal(keep_n, N.nms_keep_sorted(kb, kv_n, thr, kind)), f"K1 == plain at n_valid {n}")
        fn = lambda: nms_cuda.nms_keep_sorted(kb, kv_n, thr, kind)  # noqa: E731
        print(f"[phase3] nms_keep_sorted B={b} K={k} n_valid<={n}: kernel {cuda_ms(fn, iters=30):.4f} ms "
              f"(device {fmt_ms(device_ms(fn))}), kept per image {keep_n.sum(1).tolist()} [{card}]")

    # -- phases 4 and 5: matching kernel, training path ----------------------
    anchors840 = A.generate_anchors(preset.anchors, (840, 840)).copy()
    k2_worst = matching_phase(dev, anchors840)
    k2 = train_phase(card, dev, preset)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_worst)

    # -- phase 6: training input ---------------------------------------------
    k2_aug = augment_phase(card, dev, preset)
    k2["launches"] += k2_aug["launches"]
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_aug["max_abs_err"])

    # -- phase 7: the rest of inference --------------------------------------
    k1_wider = wider_phase(card, dev, preset, state)

    # -- phase 8: the other 14 presets ---------------------------------------
    k1_presets, k2_presets = presets_phase(card, dev)
    k2["launches"] += k2_presets["launches"]
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_presets["max_abs_err"])

    # -- phase 9: the app surface -------------------------------------------
    app = app_phase(card, dev)

    # -- phase 10: the recognition half --------------------------------------
    rec = recognition_phase(card, dev, preset, state)

    # -- phase 11: the kernels line ------------------------------------------
    kernels = [{
        "name": "nms_keep_sorted",
        "route": "cuda",
        "source": "jabd_tpu_torch/csrc/nms.cu",
        "replaces": "jabd_tpu/ops/nms_pallas.py:42",
        "launches": main_launches + k1_wider["launches"] + k1_presets["launches"] + app["k1"] + rec["launches"],
        "max_abs_err": max(worst, k1_wider["max_abs_err"], k1_presets["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }, {
        "name": "match_front",
        "route": "cuda",
        "source": "jabd_tpu_torch/csrc/matching.cu",
        "replaces": "jabd_tpu/ops/matching_pallas.py:37",
        **{**k2, "launches": k2["launches"] + app["k2"]},
        # No single torch call computes the front half (per-prior best GT
        # and per-GT best prior over the IoU matrix).
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
