"""PyTorch port, the layer spans and counters (utils/tracing.py) on the
CPU at 64x64 in float32:

- off (no profiler): a span enters no record_function, makes no CUDA event
  and keeps nothing, through the detect call and the training step too;
- on: `Predictor.detect_images` gives one kineto set of the nine stage
  spans per call, nested in its `jabd.detect` range, that
  `portbench.tracing`'s idle naming finds; data and spatial mesh calls
  one set a replica; a training step gives forward, loss > match,
  backward and optimizer; a recognition step (`jabd.rectrain.step`) gives
  forward, head, backward and optimizer, those four timed on the card's
  stream; each `jabd.serve.batch` holds its detect call;
- self time, sessions, the export guard, `profiling.trace`'s file;
- stream time from timing events (faked on the CPU), folded and reused
  once complete; the counter tensors kernels add to;
- the plain version's K1 counters against a brute-force count;
- the benchmark's readers of the spans on hand-built readings.
"""

import dataclasses
import json
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jabd_tpu_torch.utils
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import serve as SV
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.ops import anchors as A
from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.ops import nms as N
from jabd_tpu_torch.ops import nms_cuda
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.utils import profiling
from jabd_tpu_torch.utils import tracing as T
from portbench import counts, harness
from portbench import tracing as PT
from tests._torch_port_spans import host_events, inside, named
from tests._torch_port_steps import one_torch_thread  # noqa: F401

SIZE = 64
PRESET = "mnet_v3_plain"
PCFG = TC.PredictConfig(confidence=0.3, input_shape=(SIZE, SIZE), max_detections=32, pre_nms_topk=128)
STAGES = ("prepare", "upload", "letterbox", "forward", "select", "k1", "compact", "download", "finish")
ROOT = Path(__file__).resolve().parent.parent


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def model_cfg():
    return dataclasses.replace(TC.get_model_config(PRESET), compute_dtype="float32")


@pytest.fixture(scope="module")
def state_dict(model_cfg):
    torch.manual_seed(3)
    return build_model(model_cfg, mode="eval", device="cpu").state_dict()


@pytest.fixture(scope="module")
def predictor(model_cfg, state_dict):
    return Predictor(model_cfg, state_dict, PCFG, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (48, 80, 3), np.uint8), rng.integers(0, 256, (70, 50, 3), np.uint8)]


def test_the_flag_is_torch_profilers():
    """Recording follows `torch.autograd.profiler._is_profiler_enabled`,
    which torch sets while a profiler records and clears after."""
    from torch.autograd import profiler as P

    assert P._is_profiler_enabled is False and not T.enabled()
    assert T.span("jabd.x") is T._OFF
    with profiler():
        assert P._is_profiler_enabled is True and T.enabled()
        assert T.span("jabd.x") is not T._OFF
    assert P._is_profiler_enabled is False and not T.enabled()


def test_off_records_nothing(monkeypatch, predictor, images, model_cfg):
    """No profiler: the detect call, a training step and K1 enter no
    record_function, make no CUDA event or counter tensor, never
    synchronize, and the recorder keeps nothing."""

    def refuse(*args, **kwargs):
        raise AssertionError("touched while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(nms_cuda, "_count_plain", refuse)
    session = T._session
    before = (dict(session.totals), len(session.pending), dict(session.counts), dict(session.device_counts))
    with T.span("jabd.detect", "cuda") as s:
        assert s is None
    T.count("k1.pairs", 5)
    assert T.device_counts(nms_cuda.COUNTERS, "cpu") is None
    predictor.detect_images(images)
    predictor.detect_preprocessed(np.zeros((1, SIZE, SIZE, 3), np.float32))
    tcfg = TC.TrainConfig(batch_size=2, image_size=SIZE, max_targets=4)
    state = TT.create_train_state(model_cfg, tcfg, 1, device="cpu")
    TT.make_train_step(model_cfg, tcfg)(state, *_batch(model_cfg))
    after = (dict(session.totals), len(session.pending), dict(session.counts), dict(session.device_counts))
    assert T._session is session and after == before


def test_detect_spans_one_set_per_call(predictor, images):
    with profiler() as prof:
        predictor.detect_images(images)
        predictor.detect_images(images[::-1])
    reading = T.read()
    assert set(reading.totals) == {"jabd.detect"} | {f"jabd.detect.{s}" for s in STAGES}
    assert all(t.count == 2 and t.stream_ns is None for t in reading.totals.values())  # nothing timed on a CPU
    top = reading.totals["jabd.detect"]
    assert top.host_ns - top.self_ns == sum(reading.totals[f"jabd.detect.{s}"].host_ns for s in STAGES)
    assert set(reading.counters) == set(nms_cuda.COUNTERS) | {"detect.upload_bytes"}
    assert 0 < reading.counters["k1.useful_pairs"] < reading.counters["k1.pairs"]

    # The kineto trace holds the ranges: one set of stages in each jabd.detect.
    host = host_events(prof)
    parents = named(host, "jabd.detect")
    assert len(parents) == 2
    for ev in parents:
        assert [c.name() for c in inside(host, ev) if c.name().startswith("jabd.")] == [f"jabd.detect.{s}" for s in STAGES]

    # portbench's idle naming finds the prepare span where no op is open.
    intervals = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()) for ev in host if ev.duration_ns() > 0)
    prep = next(i for i in intervals if i[2] == "jabd.detect.prepare")
    covered = sorted((s, e) for s, e, n in intervals if prep[0] < s < prep[1])
    gaps, at = [], prep[0]
    for s, e in covered:
        gaps.append((at, s))
        at = max(at, e)
    gaps.append((at, prep[1]))
    a, b = max(gaps, key=lambda g: g[1] - g[0])
    assert b > a and PT._innermost(intervals, [(a + b) // 2]) == ["jabd.detect.prepare"]


def upload_bytes(images) -> int:
    plan_bytes = len(images) * 4 * (1 + I.LETTERBOX_TAPS_K + 1) * (SIZE + SIZE)
    return sum(im.nbytes for im in images) + plan_bytes


def test_upload_bytes_count_what_crosses_to_the_device(predictor, images):
    """A detect_images call counts the images' own bytes and the plans':
    per image, axis and canvas row a tap index, two weights and a pasted
    flag, four bytes each. A second call counts as much again; off, the
    counter stays as the last session left it."""
    want = upload_bytes(images)
    with profiler():
        predictor.detect_images(images)
    assert T.read().counters["detect.upload_bytes"] == want
    with profiler():
        predictor.detect_images(images)
        predictor.detect_images(images[::-1])
    assert T.read().counters["detect.upload_bytes"] == 2 * want
    predictor.detect_images(images)
    assert T.read().counters["detect.upload_bytes"] == 2 * want


def test_preprocessed_spans(predictor):
    with profiler() as prof:
        predictor.detect_preprocessed(np.zeros((2, SIZE, SIZE, 3), np.float32))
    stages = [f"jabd.detect.{s}" for s in ("upload", "forward", "select", "k1", "compact")]
    assert list(T.read().totals) == stages + ["jabd.detect"]  # in the order they closed
    host = host_events(prof)
    (top,) = named(host, "jabd.detect")
    assert [c.name() for c in inside(host, top) if c.name().startswith("jabd.")] == stages


@pytest.mark.parametrize("partition", ["data", "spatial"])
def test_mesh_spans_one_set_per_replica(model_cfg, state_dict, images, partition):
    pred = Predictor(model_cfg, state_dict, PCFG, mesh=M.make_mesh(["cpu", "cpu"]), partition=partition)
    with profiler():
        pred.detect_images(images)
    totals = T.read().totals
    replicas = 2 if partition == "data" else 1
    for stage in ("letterbox", "forward", "select", "k1", "compact"):
        assert totals[f"jabd.detect.{stage}"].count == replicas
    assert totals["jabd.detect"].count == totals["jabd.detect.prepare"].count == 1
    assert T.read().counters["detect.upload_bytes"] == upload_bytes(images)


def _batch(model_cfg, seed=5, bsz=2, g=4):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(0, 50, (bsz, SIZE, SIZE, 3)).astype(np.float32))
    cxy = rng.uniform(0.25, 0.75, (bsz, g, 2))
    wh = rng.uniform(0.15, 0.45, (bsz, g, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    landms = np.repeat(cxy, 5, axis=1).reshape(bsz, g, 10).astype(np.float32)
    targets = TL.Targets(
        torch.from_numpy(boxes), torch.ones(bsz, g), torch.from_numpy(landms), torch.ones(bsz, g, dtype=torch.bool)
    )
    anchors = torch.from_numpy(A.generate_anchors(model_cfg.anchors, (SIZE, SIZE)).copy())
    return images, targets, anchors


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans(model_cfg, microbatches):
    bsz = 2 * microbatches  # train-mode BatchNorm wants 2 images a chunk
    tcfg = TC.TrainConfig(batch_size=bsz, image_size=SIZE, max_targets=4, microbatches=microbatches)
    state = TT.create_train_state(model_cfg, tcfg, 1, device="cpu")
    step = TT.make_train_step(model_cfg, tcfg)
    with profiler() as prof:
        step(state, *_batch(model_cfg, bsz=bsz))
        step(state, *_batch(model_cfg, bsz=bsz))
    totals = T.read().totals
    phases = ["forward", "loss", "match", "backward"] * microbatches + ["optimizer"]
    assert {n: t.count for n, t in totals.items()} == {
        "jabd.train.step": 2, **{f"jabd.train.{p}": 2 * phases.count(p) for p in phases}
    }
    host = host_events(prof)
    steps = named(host, "jabd.train.step")
    assert len(steps) == 2
    for ev in steps:
        kids = [c for c in inside(host, ev) if c.name().startswith("jabd.")]
        assert [c.name() for c in kids] == [f"jabd.train.{p}" for p in phases]
        for loss in (c for c in kids if c.name() == "jabd.train.loss"):
            assert [c.name() for c in inside(kids, loss)] == ["jabd.train.match"]
    loss = totals["jabd.train.loss"]
    assert loss.self_ns == loss.host_ns - totals["jabd.train.match"].host_ns < loss.host_ns


def _rec_step(microbatches=1):
    """A tiny recognition train state (IR-18 at 32x32, 64-d, AdaFace over
    10 classes, dropout 0.4) and its float32 step."""
    from jabd_tpu_torch.recognition import heads as RH
    from jabd_tpu_torch.recognition import net as RN
    from jabd_tpu_torch.recognition import train as RT

    torch.manual_seed(0)
    state = RT.create_state(RN.IRBackbone(18, "ir", 64, 0.4, 32), RH.AdaFaceHead(10, 64), 100, lr=0.1)
    bsz = 2 * microbatches  # train-mode BatchNorm wants 2 images a chunk
    images = torch.rand(bsz, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    return state, RT.make_train_step(microbatches=microbatches, seed=3), images, torch.arange(bsz) % 10


@pytest.mark.parametrize("microbatches", [1, 2])
def test_rectrain_step_spans(monkeypatch, microbatches):
    """Each recognition step gives one `jabd.rectrain.step` holding, per
    chunk, forward, head and backward, then optimizer; those four time the
    card's stream (they pass the device), the step does not."""
    state, step, images, labels = _rec_step(microbatches)
    timed = set()
    span = T.span

    def spy(name, device=None):
        if device is not None:
            timed.add(name)
        return span(name, device)

    monkeypatch.setattr(T, "span", spy)
    with profiler() as prof:
        step(state, images, labels)
        step(state, images, labels)
    totals = T.read().totals
    phases = ["forward", "head", "backward"] * microbatches + ["optimizer"]
    assert {n: t.count for n, t in totals.items()} == {
        "jabd.rectrain.step": 2, **{f"jabd.rectrain.{p}": 2 * phases.count(p) for p in phases}
    }
    assert timed == {f"jabd.rectrain.{p}" for p in ("forward", "head", "backward", "optimizer")}
    host = host_events(prof)
    steps = named(host, "jabd.rectrain.step")
    assert len(steps) == 2
    for ev in steps:
        kids = [c for c in inside(host, ev) if c.name().startswith("jabd.")]
        assert [c.name() for c in kids] == [f"jabd.rectrain.{p}" for p in phases]


def test_rectrain_step_off_records_nothing(monkeypatch):
    """No profiler: the recognition step enters no record_function, makes
    no CUDA event and the recorder keeps nothing."""
    state, step, images, labels = _rec_step()

    def refuse(*args, **kwargs):
        raise AssertionError("touched while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    session = T._session
    before = (dict(session.totals), len(session.pending), dict(session.counts))
    step(state, images, labels)
    assert T._session is session and (dict(session.totals), len(session.pending), dict(session.counts)) == before
    assert state.step == 1


def test_self_time_is_duration_minus_children():
    with profiler():
        with T.span("jabd.a"):
            time.sleep(0.002)
            with T.span("jabd.b"):
                time.sleep(0.002)
            with T.span("jabd.c"):
                with T.span("jabd.d"):
                    time.sleep(0.001)
    t = T.read().totals
    assert t["jabd.a"].self_ns == t["jabd.a"].host_ns - t["jabd.b"].host_ns - t["jabd.c"].host_ns
    assert t["jabd.c"].self_ns == t["jabd.c"].host_ns - t["jabd.d"].host_ns
    assert t["jabd.b"].self_ns == t["jabd.b"].host_ns and t["jabd.a"].self_ns >= 2_000_000


def test_sessions_do_not_mix():
    with profiler():
        with T.span("jabd.first"):
            T.count("k1.pairs", 3)
    assert list(T.read().totals) == ["jabd.first"] and T.read().counters == {"k1.pairs": 3}
    with profiler():
        with T.span("jabd.second"):
            pass
    reading = T.read()
    assert list(reading.totals) == ["jabd.second"] and reading.counters == {}
    with profiler():
        pass
    assert T.read() == T.Reading({}, {})


def test_spans_stay_out_of_exported_graphs():
    class Graph(torch.nn.Module):
        def forward(self, boxes, valid):
            with T.span("jabd.detect.k1"):
                return nms_cuda.nms_keep_sorted(boxes, valid, 0.3)

    boxes, valid = _candidates(np.random.default_rng(1), 2, 16, [16, 9])
    with profiler():
        program = torch.export.export(Graph(), (boxes, valid))
    targets = [str(n.target) for n in program.graph.nodes]
    assert not any("profiler" in t for t in targets) and any("nms_keep_sorted" in t for t in targets)
    assert T.read() == T.Reading({}, {})


def test_profiling_trace_file_carries_the_spans(tmp_path, predictor, images):
    with profiling.trace(str(tmp_path)):
        predictor.detect_images(images)
    names = {ev.get("name") for ev in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"jabd.detect"} | {f"jabd.detect.{s}" for s in STAGES} <= names


def test_serve_batch_spans(predictor):
    det = SV.BatchingDetector(predictor, batch_size=4, max_wait_ms=300.0)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (40, 60, 3), np.uint8) for _ in range(3)]
    try:
        with profiler() as prof:
            with ThreadPoolExecutor(3) as pool:
                list(pool.map(det.detect, frames))
            deadline = time.monotonic() + 10.0
            while det.stats()["requests"] < 3 and time.monotonic() < deadline:
                time.sleep(0.01)  # the collector counts a batch after answering it
        stats = det.stats()
    finally:
        det.close()
    totals = T.read().totals
    assert totals["jabd.serve.batch"].count == totals["jabd.detect"].count == stats["batches"] >= 1
    host = host_events(prof)
    for ev in named(host, "jabd.serve.batch"):
        assert [c.name() for c in inside(host, ev) if c.name() == "jabd.detect"] == ["jabd.detect"]
    assert 0.0 <= stats["wait_mean_ms"] <= stats["wait_max_ms"] < 300.0 + 1000.0


def test_threads_keep_their_own_parents():
    """Spans opened on many threads at once: each child's time is taken
    off its own thread's parent only; no span or count lost."""
    threads, per = 16, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        for _ in range(per):
            with T.span(f"jabd.outer{t}"):
                with T.span(f"jabd.inner{t}"):
                    T.count("k1.pairs", 1)

    try:
        with profiler():
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(work, range(threads)))
    finally:
        sys.setswitchinterval(switch)
    reading = T.read()
    assert len(reading.totals) == 2 * threads
    for t in range(threads):
        outer, inner = reading.totals[f"jabd.outer{t}"], reading.totals[f"jabd.inner{t}"]
        assert outer.count == inner.count == per and inner.self_ns == inner.host_ns
        assert outer.self_ns == outer.host_ns - inner.host_ns
    assert reading.counters == {"k1.pairs": threads * per}


class _FakeEvent:
    """A timing event on a CPU-only machine: each completes `ms` after
    the one before on its stream; `done` says whether it has."""

    made = 0
    done = True

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.at = None
        self.synced = False

    def record(self, stream=None):
        self.at = 2.0 if self.at is None else self.at + 2.0

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        return 1.5  # ms


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "done", True)
    return _FakeEvent


def test_stream_time_sums_each_spans_events(fake_events):
    with profiler():
        for _ in range(3):
            with T.span("jabd.x", "cuda:0"):
                pass
        with T.span("jabd.y", "cpu"):
            pass
    totals = T.read().totals
    assert totals["jabd.x"].stream_ns == 3 * 1_500_000 and totals["jabd.y"].stream_ns is None


def test_completed_events_are_folded_and_reused(fake_events):
    """The recorder holds at most FOLD_AT timed spans whose events may be
    open, and reuses the events of those it has added up."""
    spans = 5 * T.FOLD_AT
    with profiler():
        for _ in range(spans):
            with T.span("jabd.x", "cuda:0"):
                pass
        assert len(T._session.pending) < T.FOLD_AT
        assert fake_events.made <= 2 * T.FOLD_AT
        fake_events.done = False  # the card falls behind: nothing folds, nothing is waited for
        for _ in range(spans):
            with T.span("jabd.x", "cuda:0"):
                pass
        pending = list(T._session.pending)
        assert len(pending) >= spans and not any(end.synced for _, _, _, end in pending)
    reading = T.read()  # waits for the open ones
    assert all(end.synced for _, _, _, end in pending) and not T._session.pending
    assert reading.totals["jabd.x"] == T.Total(2 * spans, *reading.totals["jabd.x"][1:3], 2 * spans * 1_500_000)


def test_device_counts_one_tensor_a_session():
    assert T.device_counts(nms_cuda.COUNTERS, "cpu") is None
    with profiler():
        slots = T.device_counts(nms_cuda.COUNTERS, "cpu")
        assert slots.tolist() == [0, 0] and T.device_counts(nms_cuda.COUNTERS, "cpu") is slots
        slots += torch.tensor([7, 3])
        T.count("k1.pairs", 1)
    assert T.read().counters == {"k1.pairs": 8, "k1.useful_pairs": 3}
    with profiler():
        assert T.device_counts(nms_cuda.COUNTERS, "cpu") is not slots
    assert T.read().counters == {"k1.pairs": 0, "k1.useful_pairs": 0}


def _candidates(rng, bsz, k, n_valid):
    """Score-sorted [B, K, 4] boxes (clustered, so NMS removes some) with
    valid prefixes of the given lengths."""
    centers = rng.uniform(0.2, 0.8, (bsz, k, 2))
    centers[:, 1::2] = centers[:, 0::2][:, : k // 2] + rng.normal(0, 0.01, (bsz, k // 2, 2))
    wh = rng.uniform(0.05, 0.2, (bsz, k, 2))
    boxes = torch.from_numpy(np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32))
    valid = torch.arange(k)[None] < torch.tensor(n_valid)[:, None]
    return boxes.contiguous(), valid.contiguous()


def test_k1_counters_equal_a_brute_force_count():
    """The plain version on the CPU: B * K evaluations a row below the
    largest n_valid; the useful pairs are (kept i, later valid j)."""
    rng = np.random.default_rng(7)
    cases = [(3, 40, [40, 17, 0]), (2, 130, [1, 129]), (1, 64, [64])]
    want = dict.fromkeys(nms_cuda.COUNTERS, 0)
    nms_ops = 0
    with profiler():
        for bsz, k, n_valid in cases:
            boxes, valid = _candidates(rng, bsz, k, n_valid)
            keep = nms_cuda.nms_keep_sorted(boxes, valid, 0.3)
            plain = N.nms_keep_sorted(boxes, valid, 0.3)
            assert torch.equal(keep, plain)
            want["k1.pairs"] += bsz * k * max(n_valid)
            for b in range(bsz):
                rows = [i for i in range(k) if valid[b, i]]
                want["k1.useful_pairs"] += sum(1 for i in rows for j in rows if j > i and plain[b, i])
            nms_ops += counts.nms_ops(plain, valid)
    got = T.read().counters
    assert got == want
    assert got["k1.useful_pairs"] == nms_ops // counts.IOU_OPS and 0 < got["k1.useful_pairs"] < got["k1.pairs"]


class _Ctx(types.SimpleNamespace):
    pass


READERS = {
    # name: (driver, expected from the hand-built reading over 4 calls)
    "host_prep_ms.detect": ("detect", 80.0 / 4),
    "upload_ms.detect": ("detect", 20.0 / 4),
    "forward_ms.detect": ("detect", 12.0 / 4),
    "wait_ms.detect": ("detect", 36.0 / 4),
    "k1_useful_pairs.detect": ("detect", 25.0),
    "forward_ms.train": ("train", 40.0 / 4),
    "loss_ms.train.re50": ("train", 8.0 / 4),
    "backward_ms.train": ("train", 60.0 / 4),
    "optimizer_ms.train.re50": ("train", 4.0 / 4),
    "forward_ms.rectrain": ("rectrain", 80.0 / 4),
    "head_ms.rectrain": ("rectrain", 6.0 / 4),
    "backward_ms.rectrain": ("rectrain", 120.0 / 4),
    "optimizer_ms.rectrain": ("rectrain", 5.0 / 4),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(monkeypatch, name):
    ms = 1_000_000
    totals = {
        "jabd.detect.prepare": (4, 80 * ms, 80 * ms, None),
        "jabd.detect.upload": (4, 20 * ms, 20 * ms, 18 * ms),
        "jabd.detect.forward": (4, 3 * ms, 3 * ms, 12 * ms),
        "jabd.detect.download": (4, 36 * ms, 36 * ms, 30 * ms),
        "jabd.train.forward": (4, 9 * ms, 9 * ms, 40 * ms),
        "jabd.train.loss": (4, 9 * ms, 5 * ms, 8 * ms),
        "jabd.train.backward": (4, 9 * ms, 9 * ms, 60 * ms),
        "jabd.train.optimizer": (4, 9 * ms, 9 * ms, 4 * ms),
        "jabd.rectrain.forward": (4, 9 * ms, 9 * ms, 80 * ms),
        "jabd.rectrain.head": (4, 2 * ms, 2 * ms, 6 * ms),
        "jabd.rectrain.backward": (4, 9 * ms, 9 * ms, 120 * ms),
        "jabd.rectrain.optimizer": (4, 3 * ms, 3 * ms, 5 * ms),
    }
    reading = T.Reading({k: T.Total(*v) for k, v in totals.items()}, {"k1.pairs": 400, "k1.useful_pairs": 100})
    driver, want = READERS[name]
    read = harness.load_reader(ROOT, name)
    ctx = _Ctx(driver=driver, calls=4)
    monkeypatch.setattr(T, "read", lambda: reading)
    assert read(ctx) == pytest.approx(want)
    assert read(_Ctx(driver="train" if driver == "detect" else "detect", calls=4)) is None
    monkeypatch.setattr(T, "read", lambda: T.Reading({}, {}))
    assert read(ctx) is None
    monkeypatch.setitem(sys.modules, "jabd_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(jabd_tpu_torch.utils, "tracing")
    assert read(ctx) is None  # a served package without the recorder
