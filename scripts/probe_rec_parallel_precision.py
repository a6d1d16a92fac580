"""Precision probe of the PyTorch port's 2-rank recognition train step on
one CUDA card: ir_18 at 112x112, AdaFace over 70,722 classes, SGD at lr
0.1, dropout 0, each step held against the same step with a float64
backbone on the host's CPU.

It asks whether a batch of 4 alone puts float32 (TF32 off) past
`chip_smoke.py [rectrain] (b)`'s bound, or whether the class-sharded path
does (`recognition/parallel.py::sharded_loss` with the synchronized
BatchNorms of `models/layers.py`). On two sets of 8 faces, the inputs of
`chip_smoke.py [parallel] (c)` when it ran 4 faces a rank, and 8 faces of
a fresh seed, under cuDNN's defaults and again with
`cudnn.benchmark=False, cudnn.deterministic=True`:

  1. one process at bs 4, against the float64 step at bs 4;
  2. one process at bs 8, against the float64 step at bs 8;
  3. two gloo ranks sharing the card at 4 faces a rank (the global bs 8),
     the head in halves, against the float64 step at bs 8, and against
     step 2 under the same flags.

Then, once per set: steps 2 and 3 in float32 on the host's CPU (another
order of the same sums), and steps 2 and 3 with a float64 backbone on the
card against the CPU's: the sharded path computes the same function when
its float64 step lies at rounding distance from the CPU's.

Errors are chip_smoke._state_errors: the worst parameter's error over
(0.05 x its change + 1e-6), the worst BatchNorm statistic's over (1e-3 x
its largest value + 1e-6), AdaFace's EMA relative error. A ratio above 1
fails [rectrain] (b)'s bound. Beside each, the PReLU inputs of the step's
forward that lie on the other side of 0 from the float64 forward's (at
such a kink the backward takes the slope alpha for 1 or 1 for alpha, a
jump no tolerance of rounding covers).

`--host` runs on the host's CPU alone, no card: on the [parallel] (c)
faces, the float64 reference against one whose head is float64 too (the
heads compute in float32 by design: does that rounding reach the
reference?), then the float32 one-process step at bs 8 under several
CPU thread counts (each another order of the same sums).

Run from the repository root on a machine with one card:
    python3 scripts/probe_rec_parallel_precision.py
or on any machine:
    python3 scripts/probe_rec_parallel_precision.py --host
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from jabd_tpu_torch.configs import TrainConfig  # noqa: E402
from jabd_tpu_torch.parallel import mesh as M  # noqa: E402
from jabd_tpu_torch.parallel import spawn  # noqa: E402
from jabd_tpu_torch.recognition import build_head  # noqa: E402
from jabd_tpu_torch.recognition import parallel as RP  # noqa: E402
from jabd_tpu_torch.recognition import train as RT  # noqa: E402

ARCH, BS, HALF = "ir_18", 8, 4


def set_flags(deterministic: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = deterministic


def fmt(errs, loss, ref_loss, kinks=None, ref_kinks=None):
    (ratio, name, err, moved), stat, ema = errs
    out = (f"loss rel err {abs(loss / ref_loss - 1):.3e}; worst parameter {ratio:.3f} of its bound ({name}: "
           f"error {err:.3e}, change {moved:.3e}); statistics {stat:.3e}; EMA {ema:.3e}")
    if kinks is not None:
        out += f"; PReLU inputs across 0 from float64: {crossings(kinks, ref_kinks) or 'none'}"
    return out


@contextlib.contextmanager
def prelu_inputs(model, into):
    """Record into `into` the input of each of `model`'s PReLUs on its first
    forward, as float64 on the CPU."""
    def hook(name):
        def record(module, args):
            if name not in into:
                into[name] = args[0].detach().double().cpu()

        return record

    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in model.named_modules()
             if type(m).__name__ == "PReLU"]
    try:
        yield into
    finally:
        for h in hooks:
            h.remove()


def crossings(got, ref):
    """'module [b, c, y, x] (float64 value)' for each PReLU input whose sign
    differs from the float64 forward's."""
    out = []
    for name, r in ref.items():
        for idx in ((got[name] > 0) != (r > 0)).nonzero().tolist():
            out.append(f"{name} {idx} ({float(r[tuple(idx)]):.2e})")
    return ", ".join(out)


@contextlib.contextmanager
def float64_head():
    """`.float()` leaves a float64 tensor as it is: with the head's kernel
    float64, the head and the loss compute in float64 too."""
    plain = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else plain(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = plain


def step_on(dev, x, y, double=False, kinks=None, head=False):
    """(state after one step, loss) on `dev` from the seeded start; the
    backbone float64 with `double` (the head stays float32 by design, and
    goes float64 too with `head`); the PReLU inputs into `kinks`."""
    state = C.rec_train_state(ARCH, "adaface", dev, dropout=0.0)
    if double:
        state.model.double()
    if head:
        state.head.double()
    with prelu_inputs(state.model, {} if kinks is None else kinks), (float64_head() if head else
                                                                      contextlib.nullcontext()):
        state, m = RT.make_train_step()(state, x.to(dev), y.to(dev))
    return state, float(m["loss"])


def parallel_c_inputs():
    """The faces and labels of chip_smoke.py [parallel] (c) at 8 faces
    (4 a rank): its draws from default_rng(12), in its order."""
    rng = np.random.default_rng(12)
    size = TrainConfig().image_size
    rng.normal(0, 50, (C.PAR_BATCH, size, size, 3))
    C.face_rows(rng, [60, 45, 3, 1])
    return faces_labels(rng)


def faces_labels(rng):
    faces = torch.from_numpy(((C.seeded_faces(rng, BS).astype(np.float32) / 255 - 0.5) / 0.5)[..., ::-1].copy())
    return faces, torch.from_numpy(rng.integers(0, C.REC_TRAIN_CLASSES, BS))


def rank(payload, mesh):
    """One rank of step 3: the class-sharded step on this rank's rows;
    rank 0 saves the gathered state."""
    set_flags(payload["deterministic"])
    model = C.rec_train_model(ARCH, mesh.device, dropout=0.0)
    if payload["double"]:
        model.double()
    head = build_head("adaface", class_num=C.REC_TRAIN_CLASSES, pad_to=mesh.size, seed=0, device=mesh.device)
    state = RT.create_state(model, head, num_train_steps_hint=1000, lr=C.REC_TRAIN_LR, milestones=(500, 800))
    step, state = RP.make_sharded_train_step(state, mesh)
    x, y = M.shard_batch((payload["faces"], payload["labels"]), mesh)
    with prelu_inputs(model, {}) as kinks:
        state, m = step(state, x.to(mesh.device), y.to(mesh.device))
    torch.save(kinks, f"{payload['out']}.prelu{mesh.rank}")
    full = state.state_dict()  # gathered: every rank takes part
    if mesh.rank == 0:
        torch.save(full, payload["out"])
    return {"loss": float(m["loss"])}


def ranks(tmp, tag, faces, labels, deterministic=False, double=False, dev=torch.device("cuda", 0)):
    """(the 2-rank step's gathered state, its loss, its PReLU inputs in row
    order), both ranks on `dev`."""
    out = os.path.join(tmp, f"{tag}.pt")
    payload = {"faces": faces, "labels": labels, "deterministic": deterministic, "double": double, "out": out}
    res = spawn.run("scripts.probe_rec_parallel_precision:rank", 2, payload, os.path.join(tmp, tag),
                    backend="gloo", device=str(dev), threads=2, timeout=600, cwd=ROOT)
    got = C.rec_train_state(ARCH, "adaface", dev, dropout=0.0)  # 70,722 is even: no padding column
    if double:
        got.model.double()
    got.load_state_dict(torch.load(out, map_location=dev, weights_only=True))
    parts = [torch.load(f"{out}.prelu{r}", weights_only=True) for r in range(2)]
    kinks = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}  # rank r holds rows [4r, 4r + 4)
    return got, res[0]["loss"], kinks


def reference(faces, labels, n, head=False):
    """The float64 step on the host's CPU at bs n: (state, start, loss,
    PReLU inputs)."""
    ref = C.rec_train_state(ARCH, "adaface", torch.device("cpu"), dropout=0.0)
    start = {k: p.detach().double().cpu().clone() for k, p in ref.named_parameters()}
    kinks = {}
    ref, loss = step_on(torch.device("cpu"), faces[:n], labels[:n], double=True, kinks=kinks, head=head)
    return ref, start, loss, kinks


def host_only():
    """The --host probe (module docstring)."""
    faces, labels = parallel_c_inputs()
    ref, start, ref_loss, ref_kinks = reference(faces, labels, BS)
    full, _, full_loss, _ = reference(faces, labels, BS, head=True)
    print(f"[host CPU] float64 backbone, float32 head against float64 throughout, bs {BS}: "
          f"{fmt(C._state_errors(ref, full, start), ref_loss, full_loss)}", flush=True)
    for threads in (1, 2, 4, 6, 8):
        torch.set_num_threads(threads)
        kinks = {}
        state, loss = step_on(torch.device("cpu"), faces, labels, kinks=kinks)
        print(f"[host CPU] float32 one process bs {BS}, {threads} threads, against float64 bs {BS}: "
              f"{fmt(C._state_errors(state, ref, start), loss, ref_loss, kinks, ref_kinks)}", flush=True)


def main():
    if sys.argv[1:] == ["--host"]:
        return host_only()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card (or --host)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    sets = {"[parallel] (c) faces": parallel_c_inputs(), "seed-21 faces": faces_labels(np.random.default_rng(21))}
    with tempfile.TemporaryDirectory(prefix="probe_rec_par_") as tmp:
        for name, (faces, labels) in sets.items():
            t0 = time.perf_counter()
            refs = {n: reference(faces, labels, n) for n in (HALF, BS)}
            print(f"[{name}] float64 CPU steps at bs {HALF} and {BS}: {time.perf_counter() - t0:.1f} s", flush=True)
            ref8, start, loss_ref8, kinks8 = refs[BS]
            for deterministic in (False, True):
                set_flags(deterministic)
                tag = f"[{name}] cudnn.benchmark=False deterministic={deterministic}"
                t0 = time.perf_counter()
                one = {}
                for n in (HALF, BS):
                    kinks = {}
                    one[n] = step_on(dev, faces[:n], labels[:n], kinks=kinks)
                    ref, start_n, ref_loss, ref_kinks = refs[n]
                    print(f"{tag} one process bs {n} against float64 bs {n}: "
                          f"{fmt(C._state_errors(one[n][0], ref, start_n), one[n][1], ref_loss, kinks, ref_kinks)}",
                          flush=True)
                got, loss, kinks = ranks(tmp, f"f32_{deterministic}_{name[:4]}", faces, labels, deterministic)
                print(f"{tag} 2 ranks at {HALF} a rank against float64 bs {BS}: "
                      f"{fmt(C._state_errors(got, ref8, start), loss, loss_ref8, kinks, kinks8)}", flush=True)
                print(f"{tag} 2 ranks at {HALF} a rank against one process bs {BS} on the card: "
                      f"{fmt(C._state_errors(got, one[BS][0], start), loss, one[BS][1])} "
                      f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
                del got, one
                torch.cuda.empty_cache()
            set_flags(False)
            t0 = time.perf_counter()
            kinks = {}
            state, loss = step_on(cpu, faces, labels, kinks=kinks)
            print(f"[{name}] host CPU float32: one process bs {BS} against float64 bs {BS}: "
                  f"{fmt(C._state_errors(state, ref8, start), loss, loss_ref8, kinks, kinks8)}", flush=True)
            got, loss, kinks = ranks(tmp, f"cpu_{name[:4]}", faces, labels, dev=cpu)
            print(f"[{name}] host CPU float32: 2 ranks at {HALF} a rank against float64 bs {BS}: "
                  f"{fmt(C._state_errors(got, ref8, start), loss, loss_ref8, kinks, kinks8)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            t0 = time.perf_counter()
            state, loss = step_on(dev, faces, labels, double=True)
            print(f"[{name}] float64 backbone: one process bs {BS} on the card against the CPU: "
                  f"{fmt(C._state_errors(state, ref8, start), loss, loss_ref8)}", flush=True)
            got, loss, _ = ranks(tmp, f"f64_{name[:4]}", faces, labels, double=True)
            print(f"[{name}] float64 backbone: 2 ranks at {HALF} a rank against the CPU: "
                  f"{fmt(C._state_errors(got, ref8, start), loss, loss_ref8)} ({time.perf_counter() - t0:.1f} s) "
                  f"[{card}]", flush=True)
            del state, got
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
