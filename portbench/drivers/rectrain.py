"""AdaFace training steps back to back: the recognition package's
`train.make_train_step` over `train.create_state` of `build_model` and
`build_head`, on a pool of device-resident batches.

Traffic parameters (portbench/traffic/<name>.json, "driver": "rectrain"):
batch, image_size, pool_batches. The configuration file gives the
backbone's preset and stage table, the head and the optimizer; the
served build is held to them (a drifted build raises).

Set-up: the pool from the seed (smooth crops in [-1, 1], labels uniform
over the classes) and the weights (the reference's seeded state dict,
loaded into the served backbone and head), then the first three steps on
pool batches 0, 1 and 2 through the window's own call: their losses, the
first gradient as SGD received it (the momentum buffers after one step),
and after the third step the parameters, the BatchNorms' running
statistics, the momentum buffers and the head's norm EMA are kept. The
window continues the same state, batch after batch, for the run's
seconds; each step's loss is read two steps later, so the host runs at
most two steps ahead; the window ends with a synchronize. After the
window the program is freed and the float32 reference
(reference/recognition.py) repeats the three steps from the same weights,
batches and dropout masks, and so does plain bfloat16 training of the
reference (the backbone under autocast), the yardstick of the `*_vs_bf16`
readings.

The control (`variant="fp8"`) serves the reference with its convolutions
in float8 (reference/model.py::set_fp8) in the program's place, through
the same set-up, window and comparison.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import counts, generators as G, tracing
from portbench.drivers.common import Outcome, Phases, device_line, reference_precision, release, reset_peak, sync
from portbench.reference import recognition as RR
from portbench.reference.train import yardstick_ratios

CHECK_STEPS = 3


class Context:
    """What the per-layer readers of a traced recognition training run
    read."""

    driver = "rectrain"

    def __init__(self, trace, served, cell):
        self.trace, self.served, self.cell = trace, served, cell
        self.calls = len(served)
        self.images = self.calls * cell.traffic["batch"]

    def flops_per_step(self) -> int:
        """The reference backbone's forward and backward at the cell's
        image size for each image of a batch (counts.model_flops), plus
        the head's three products (logits, the embeddings' and the
        kernel's gradients: 3 x 2 x B x D x C)."""
        tr, cfg = self.cell.traffic, self.cell.config
        s = tr["image_size"]
        image = counts.model_flops(lambda: RR.IRBackbone(cfg["model"]).eval(), (1, 3, s, s), backward=True)
        head = 3 * 2 * tr["batch"] * cfg["model"]["embedding_size"] * cfg["head"]["class_num"]
        return image * tr["batch"] + head


def _half(step):
    """Half of the batch left out: the step sees its first half only."""
    def call(state, images, labels):
        h = images.shape[0] // 2
        return step(state, images[:h], labels[:h])
    return call


def _altered(step):
    """The loss the step reports is 5% off."""
    def call(state, images, labels):
        state, metrics = step(state, images, labels)
        return state, {**metrics, "loss": metrics["loss"] * 1.05}
    return call


def _restoring(pick):
    """A fault that puts back, after each step, the entries of the
    combined state dict (`model.` and `head.` names) that `pick` accepts."""
    def fault(step):
        def call(state, images, labels):
            saved = {prefix + k: v.clone() for prefix, mod in (("model.", state.model), ("head.", state.head))
                     for k, v in mod.state_dict().items() if pick(prefix + k)}
            out = step(state, images, labels)
            for prefix, mod in (("model.", state.model), ("head.", state.head)):
                part = {k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)}
                if part:
                    mod.load_state_dict(part, strict=False)
            return out
        return call
    return fault


# Faults planted under the served call, for the limits tool and the tests:
# the state left as it was (parameters, BatchNorm statistics, the head's
# EMA), half the batch, the loss 5% off, the BatchNorms' running statistics
# left as they were, the head's kernel left unupdated, the head's norm EMA
# left as it was (a fault of one buffer pair).
FAULTS = {"unchanged": _restoring(lambda k: True), "half": _half, "altered": _altered,
          "stats_frozen": _restoring(lambda k: "running_" in k),
          "kernel_frozen": _restoring(lambda k: k == "head.kernel"),
          "ema_frozen": _restoring(lambda k: k in ("head.batch_mean", "head.batch_std"))}


def port_build(config: dict, dev):
    """The served backbone and head built as `recognition.cli train` builds
    them (`build_model`, `build_head`) and their train state at the
    recipe's lr, held to the configuration file's numbers."""
    from jabd_tpu_torch.recognition import build_head, build_model
    from jabd_tpu_torch.recognition import net as N
    from jabd_tpu_torch.recognition import train as T

    m, hd, opt = config["model"], config["head"], config["optimizer"]
    model = build_model(config["preset"], device=dev)
    head = build_head(hd["type"], embedding_size=m["embedding_size"], class_num=hd["class_num"], m=hd["m"],
                      h=hd["h"], t_alpha=hd["t_alpha"], s=hd["s"], device=dev)
    state = T.create_state(model, head, num_train_steps_hint=1 << 40, lr=opt["lr"])
    side = m["image_size"]
    for _ in m["stages"]:
        side = -(-side // 2)
    groups = state.optimizer.param_groups
    have = {"stages": [list(s) for s in N.IR_STAGES[model.num_layers]], "mode": model.mode,
            "embedding_size": model.embedding_size, "dropout": model.dropout, "fc_in": model.fc.in_features,
            "head": (type(head).__name__, head.classnum, head.m, head.h, head.s, head.t_alpha, head.eps),
            "optimizer": (state.lr, groups[0]["momentum"], groups[0]["weight_decay"], groups[1]["weight_decay"])}
    want = {"stages": m["stages"], "mode": m["mode"], "embedding_size": m["embedding_size"], "dropout": m["dropout"],
            "fc_in": m["stages"][-1][0] * side * side,
            "head": ("AdaFaceHead", hd["class_num"], hd["m"], hd["h"], hd["s"], hd["t_alpha"], hd["eps"]),
            "optimizer": (opt["lr"], opt["momentum"], opt["weight_decay"], 0.0)}
    diff = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if diff:
        raise ValueError(f"the served recognition build differs from its configuration file: {diff}")
    return state


def make_pool(traffic: dict, config: dict, seed: int, dev):
    """`pool_batches` device-resident batches: float32 NHWC crops in
    [-1, 1] of smooth content, and labels uniform over the classes."""
    gen = G.torch_gen(seed, 2, dev)
    b, s = traffic["batch"], traffic["image_size"]
    pool = []
    for _ in range(traffic["pool_batches"]):
        images = G.smooth_images(gen, b, s, s, dev).float() / 127.5 - 1.0
        labels = torch.randint(0, config["head"]["class_num"], (b,), generator=gen, device=dev)
        pool.append((images, labels))
    return pool


@torch.no_grad()
def seeded_state(config: dict, seed: int, dev) -> dict:
    """The reference's seeded weights as a combined host state dict:
    convolutions and BatchNorms by generators.seed_weights, the Linear
    N(0, 1/fan_in) with bias N(0, 0.1^2), the head's kernel N(0, 0.01^2)
    (its columns are normalized), PReLU alphas at 0.25."""
    model, head = (x.to(dev) for x in RR.build(config))
    gen = G.torch_gen(seed, 3, dev)
    G.seed_weights(model, gen)
    fc = model.fc
    fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen, device=dev) * fc.in_features ** -0.5)
    fc.bias.copy_(0.1 * torch.randn(fc.bias.shape, generator=gen, device=dev))
    head.kernel.copy_(0.01 * torch.randn(head.kernel.shape, generator=gen, device=dev))
    return RR.state_dict(model, head)


class _Served:
    """The side the check judges: the program's train state (`variant`
    None) or the reference in float8 (`variant` "fp8"), each behind one
    `step(i)` that runs pool batch i and returns its loss."""

    def __init__(self, cell, p0, pool, dev, variant, fault, step_seed):
        self.pool = pool
        if variant is None:
            from jabd_tpu_torch.recognition import train as T

            state = port_build(cell.config, dev)
            RR.load(state.model, state.head, p0)
            step = T.make_train_step(compute_dtype=cell.config["compute_dtype"], seed=step_seed)
            if fault is not None:
                step = fault(step)
            self.model, self.head, self._opt = state.model, state.head, state.optimizer
            self._call = lambda images, labels: step(state, images, labels)[1]["loss"]
        elif variant == "fp8":
            trainer = RR.Trainer(cell.config, p0, dev, step_seed, fp8=True)
            self.model, self.head, self._opt, self._trainer = trainer.model, trainer.head, None, trainer

            def call(images, labels):
                with reference_precision():
                    return trainer.step(images, labels)
            self._call = call
        else:
            raise ValueError(f"no control {variant!r} for recognition training")

    def step(self, i):
        images, labels = self.pool[i % len(self.pool)]
        return self._call(images, labels)

    def momentum(self):
        """SGD's momentum buffers by combined parameter name."""
        if self._opt is None:
            return self._trainer.buf
        return {n: self._opt.state[p]["momentum_buffer"] for n, p in RR.named_parameters(self.model, self.head).items()}


def run(cell, seed, seconds, trace, t_start, device=None, variant=None, fault=None) -> Outcome:
    dev = torch.device(device or "cuda")
    phases = Phases(t_start, dev)
    tr, cfg = cell.traffic, cell.config
    step_seed = seed % (1 << 31)
    pool = make_pool(tr, cfg, seed, dev)
    phases.mark("batches")
    p0 = seeded_state(cfg, seed, dev)
    release(dev)
    reset_peak(dev)
    phases.mark("weights")

    served_state = _Served(cell, p0, pool, dev, variant, fault, step_seed)
    do = served_state.step
    phases.mark("train state")

    losses = []
    for i in range(CHECK_STEPS):
        losses.append(float(do(i)))
        if i == 0:
            grad1 = {n: x.cpu().clone() for n, x in served_state.momentum().items()}
    after = RR.snapshot(served_state.model, served_state.head, served_state.momentum())
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
            with torch.profiler.record_function("portbench.rectrain_step"):
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

    with reference_precision():
        ref = RR.reference_steps(cfg, p0, pool[:CHECK_STEPS], dev, step_seed)
        release(dev)
        plain = RR.reference_steps(cfg, p0, pool[:CHECK_STEPS], dev, step_seed, bf16=True)
    release(dev)
    readings = RR.train_gaps(losses, grad1, after, p0, ref)
    plain_gaps = RR.train_gaps(plain["losses"], plain["grad1"], plain["after"], p0, ref)
    readings.update(yardstick_ratios(readings, plain_gaps))
    extra = {**RR.train_diagnostics(losses, grad1, after, p0, ref), "bf16": plain_gaps}
    ctx = None
    if trace:
        ctx = Context(window.trace, served, cell)
        device_info = {**device_info, "busy_s": window.trace.busy_s, "window_s": window.trace.window_s}
    return Outcome(attempted=len(served), failed=failed, end_to_end=end_to_end, readings=readings,
                   device=device_info, ctx=ctx, extra=extra)
