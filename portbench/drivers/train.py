"""Training steps back to back: `train.make_train_step` over
`train.create_train_state`, on a pool of device-resident batches.

Traffic parameters (portbench/traffic/<name>.json, "driver": "train"):
batch, image_size, max_targets, pool_batches, source_width,
faces_per_image, face_px, landmark_share, calibration_images.

Set-up: the pool and the weights from the seed (the reference model's
seeded, BatchNorm-calibrated state dict, loaded into the served package's
train state), then the first three steps on pool batches 0, 1 and 2
through the window's own call: their losses, the first gradient as Adam
received it (its first moment after one step over 1 - beta1), and after
the third step the parameters, the BatchNorms' running statistics and
Adam's moments are kept. The window continues the same state, batch after
batch, for the run's seconds; each step's loss is read two steps later,
so the host runs at most two steps ahead; the window ends with a
synchronize. After the window the program is freed and the float32
reference (reference/train.py) repeats the three steps from the same
weights and batches, and so does plain bfloat16 training of the
reference (autocast), the yardstick of the `*_vs_bf16` readings.

The control (`variant="fp8"`) serves the reference with its convolutions
in float8 (reference/model.py::set_fp8) in the program's place, through
the same set-up, window and comparison.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import counts, generators as G, tracing
from portbench.drivers.common import (Outcome, Phases, device_line, port_model_config, reference_precision,
                                      release, reset_peak, sync)
from portbench.reference import detect as RD
from portbench.reference import train as RT
from portbench.reference.model import RetinaFace

CHECK_STEPS = 3


class Context:
    """What the per-layer readers of a traced training run read."""

    driver = "train"

    def __init__(self, trace, served, pool, cell, priors):
        self.trace, self.served, self.pool, self.cell, self.priors = trace, served, pool, cell, priors
        self.calls = len(served)
        self.images = self.calls * cell.traffic["batch"]

    def flops_per_image(self) -> int:
        s = self.cell.traffic["image_size"]
        return counts.model_flops(lambda: RetinaFace(self.cell.config["model"], "train"), (1, 3, s, s), backward=True)

    def k2_bound_s(self) -> float:
        """The least time of K2 over the traced steps (counts.match_ops and
        match_bytes of each step's targets)."""
        per_batch = {}
        for i in set(self.served):
            boxes, _, _, valid = self.pool[i][1]
            per_batch[i] = counts.bound_s(counts.match_ops(boxes, valid, self.priors),
                                          counts.match_bytes(*valid.shape, self.priors.shape[0]))
        return sum(per_batch[i] for i in self.served)


def _half(step):
    """Half of the batch left out: the step sees its first half only."""
    def call(state, images, targets, anchors):
        h = images.shape[0] // 2
        return step(state, images[:h], type(targets)(*(t[:h] for t in targets)), anchors)
    return call


def _altered(step):
    """The loss the step reports is 5% off."""
    def call(state, images, targets, anchors):
        state, metrics = step(state, images, targets, anchors)
        return state, {**metrics, "loss": metrics["loss"] * 1.05}
    return call


def _restoring(pick):
    """A fault that puts back, after each step, the entries of the model's
    state dict whose names `pick` accepts."""
    def fault(step):
        def call(state, images, targets, anchors):
            saved = {k: v.clone() for k, v in state.model.state_dict().items() if pick(k)}
            out = step(state, images, targets, anchors)
            state.model.load_state_dict(saved, strict=False)
            return out
        return call
    return fault


# Faults planted under the served call, for the limits tool and the tests:
# the state left as it was (parameters and BatchNorm statistics), half the
# batch, the loss 5% off, the BatchNorms' running statistics left as they
# were (the parameters still move), the detection heads left unupdated (a
# fault of a few leaves).
FAULTS = {"unchanged": _restoring(lambda k: True), "half": _half, "altered": _altered,
          "stats_frozen": _restoring(lambda k: "running_" in k),
          "heads_frozen": _restoring(lambda k: "_head" in k)}


def train_config(cell):
    """The served package's TrainConfig at the traffic's sizes, held to
    the configuration file's recipe."""
    from jabd_tpu_torch import configs as C

    tr, recipe = cell.traffic, cell.config["train"]
    tcfg = C.TrainConfig(batch_size=tr["batch"], image_size=tr["image_size"], max_targets=tr["max_targets"])
    have = {"lr": tcfg.lr_freeze, "weight_decay": tcfg.weight_decay, "overlap_threshold": tcfg.overlap_threshold,
            "neg_pos_ratio": tcfg.neg_pos_ratio, "loc_weight": tcfg.loc_weight}
    diff = {k: (v, recipe[k]) for k, v in have.items() if v != recipe[k]}
    if diff:
        raise ValueError(f"the served training recipe differs from the configuration file: {diff}")
    return tcfg


def seeded_state(cell, seed, pool, dev) -> dict:
    """The reference model's seeded weights, BatchNorms calibrated on the
    first pool batch's first images, as a host state dict."""
    ref = RetinaFace(cell.config["model"], "train").to(dev)
    G.seed_weights(ref, G.torch_gen(seed, 3, dev))
    with reference_precision():
        x = pool[0][0][: cell.traffic["calibration_images"]].permute(0, 3, 1, 2)
        G.calibrate_batchnorms(ref, x)
    return {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}


class _Served:
    """The side the check judges: the program's train state (`variant`
    None) or the reference in float8 (`variant` "fp8"), each behind one
    `step(i)` that runs pool batch i and returns its loss."""

    def __init__(self, cell, p0, pool, dev, variant, fault):
        from jabd_tpu_torch import losses as L
        from jabd_tpu_torch import train as T
        from jabd_tpu_torch.ops import anchors as A

        size = (cell.traffic["image_size"],) * 2
        self.pool = pool
        if variant is None:
            port_cfg, tcfg = port_model_config(cell.config), train_config(cell)
            state = T.create_train_state(port_cfg, tcfg, steps_per_epoch=1 << 40, device=dev)
            state.model.load_state_dict(p0)
            step = T.make_train_step(port_cfg, tcfg)
            if fault is not None:
                step = fault(step)
            anchors = torch.from_numpy(A.generate_anchors(port_cfg.anchors, size).copy()).to(dev)
            self.model, self._opt = state.model, state.optimizer
            self._call = lambda images, targets: step(state, images, L.Targets(*targets), anchors)[1]["loss"]
        elif variant == "fp8":
            trainer = RT.Trainer(cell.config, p0, dev, fp8=True)
            priors = RD.anchors(cell.config["model"]["anchors"], size).to(dev)
            self.model, self._opt, self._trainer = trainer.model, None, trainer

            def call(images, targets):
                with reference_precision():
                    return trainer.step(images, targets, priors)
            self._call = call
        else:
            raise ValueError(f"no control {variant!r} for training")

    def step(self, i):
        images, targets = self.pool[i % len(self.pool)]
        return self._call(images, targets)

    def moments(self):
        """Adam's first and second moments by parameter name."""
        if self._opt is None:
            return self._trainer.m, self._trainer.v
        names = [(n, self._opt.state[p]) for n, p in self.model.named_parameters()]
        return {n: s["exp_avg"] for n, s in names}, {n: s["exp_avg_sq"] for n, s in names}


def run(cell, seed, seconds, trace, t_start, device=None, variant=None, fault=None) -> Outcome:
    dev = torch.device(device or "cuda")
    phases = Phases(t_start, dev)
    tr = cell.traffic
    train_config(cell)
    pool = G.train_pool(tr, seed, dev)
    phases.mark("batches")
    p0 = seeded_state(cell, seed, pool, dev)
    release(dev)
    reset_peak(dev)
    phases.mark("weights")

    served_state = _Served(cell, p0, pool, dev, variant, fault)
    do = served_state.step
    phases.mark("train state")

    losses = []
    for i in range(CHECK_STEPS):
        losses.append(float(do(i)))
        if i == 0:
            grad1 = RT.first_gradient(served_state.moments()[0])
    after = RT.snapshot(served_state.model, *served_state.moments())
    sync(dev)
    setup_s = time.perf_counter() - t_start
    phases.mark("first three steps")
    phases.report()

    served, pending, failed = [], [], 0
    window = tracing.Window(dev) if trace else contextlib.nullcontext()
    with window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = CHECK_STEPS + len(served)
            with torch.profiler.record_function("portbench.train_step"):
                pending.append(do(i))
            served.append(i % len(pool))
            if len(pending) > 2:
                failed += not torch.isfinite(pending.pop(0)).item()
        failed += sum(not torch.isfinite(v).item() for v in pending)
        sync(dev)
        window_s = time.perf_counter() - t0
    device_info = device_line(dev)
    del served_state, do, pending
    release(dev)
    end_to_end = {"train_img_per_s": tr["batch"] * len(served) / window_s, "setup_s": setup_s}

    size = (tr["image_size"], tr["image_size"])
    priors = RD.anchors(cell.config["model"]["anchors"], size).to(dev)
    with reference_precision():
        ref = RT.reference_steps(cell.config, p0, pool[:CHECK_STEPS], priors, dev)
        plain = RT.reference_steps(cell.config, p0, pool[:CHECK_STEPS], priors, dev, bf16=True)
    readings = RT.train_gaps(losses, grad1, after, p0, ref)
    plain_gaps = RT.train_gaps(plain["losses"], plain["grad1"], plain["after"], p0, ref)
    readings.update(RT.yardstick_ratios(readings, plain_gaps))
    extra = {**RT.train_diagnostics(losses, grad1, after, p0, ref), "bf16": plain_gaps}
    ctx = None
    if trace:
        ctx = Context(window.trace, served, pool, cell, priors)
        device_info = {**device_info, "busy_s": window.trace.busy_s, "window_s": window.trace.window_s}
    return Outcome(attempted=len(served), failed=failed, end_to_end=end_to_end, readings=readings,
                   device=device_info, ctx=ctx, extra=extra)
