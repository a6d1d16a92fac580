"""What each rank runs in the port's multi-process tests
(`jabd_tpu_torch.parallel.spawn.run("tests._torch_port_parallel_tasks:<fn>",
...)`): torch, numpy and the port only, never JAX. Every function takes the
payload the test saved and this rank's process mesh, and returns what the
test compares; the same function called in the test process with a mesh of
one (`one_process`) is the single-process reference on the global batch.
"""

import dataclasses
import os

import numpy as np
import torch

from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import step as ST
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models import layers as TLayers
from jabd_tpu_torch.parallel import fsdp as FS
from jabd_tpu_torch.parallel import mesh as M
from tests._torch_port_spans import span_tree


def one_process(fn, payload):
    """`fn` in this process on a mesh of one CPU device."""
    return fn(payload, M.Mesh(["cpu"]))


def _local_variants(variants):
    """The wrong variants the unequal-halves test must catch: per-rank loss
    normalization (the counts not summed over the mesh) and per-rank
    BatchNorm statistics (no synchronized BatchNorm). Only the spawned
    ranks take them: they patch the modules for the process's life."""
    if "local_norm" in variants:
        class LocalCounts:
            def __getattr__(self, name):
                return getattr(M, name)

            @staticmethod
            def all_reduce(x, mesh, op=None):
                return x.detach().clone()

        TL.M = LocalCounts()
    if "local_bn" in variants:
        TLayers.convert_sync_batchnorm = lambda model, mesh: model


def det_step(payload, mesh):
    """One detector train step (make_train_step(mesh=)) from the payload's
    weights on its global batch, this rank's rows. Returns metrics,
    gradients and the model's state (running statistics) as float64
    numpy, and FSDP facts."""
    _local_variants(payload.get("variants", ()))
    dtype = payload.get("dtype", torch.float32)
    cfg = dataclasses.replace(TC.get_model_config(payload.get("preset", "jabd_flagship")), compute_dtype="float32")
    tcfg = TC.TrainConfig(**payload["kw"])
    model = build_model(cfg, mode="train", device="cpu")
    model.load_state_dict(payload["state"])
    model.to(dtype)
    TT.place_on_mesh(model, mesh, tcfg.fsdp)
    state = TT.TrainState(model=model, optimizer=TT.make_optimizer(model.parameters(), 1e-3), lr=1e-3,
                          steps_per_epoch=1, gamma=0.92, mesh=mesh)
    mb = max(tcfg.microbatches, 1)

    def cast(x):
        return x.to(dtype) if x.dtype == torch.float32 else x

    inputs = tuple(payload["inputs"])
    targets = TL.Targets(*payload["targets"])
    if M.is_sharded(mesh):
        inputs, targets = M.shard_batch((inputs, targets), mesh, chunks=mb)
    anchors = cast(payload["anchors"])
    if tcfg.device_augment and dtype != torch.float32:
        # The augmentation makes float32 frames; a float64 model takes them cast.
        from jabd_tpu_torch.data import device_augment as DA

        augment = DA.device_augment
        DA.device_augment = lambda *a, **k: augment(*a, **k).to(dtype)
        step = TT.make_train_step(cfg, tcfg, mesh=mesh)  # binds the cast one
        DA.device_augment = augment
    else:
        step = TT.make_train_step(cfg, tcfg, mesh=mesh)
    if tcfg.device_augment:
        state, metrics = step(state, inputs[0], inputs[1], TL.Targets(*map(cast, targets)), anchors)
    else:
        state, metrics = step(state, cast(inputs[0]), TL.Targets(*map(cast, targets)), anchors)
    out = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: FS.full_tensor(p, p.grad).double().numpy() for k, p in model.named_parameters()
                  if p.grad is not None},
        "state": {k: v.double().numpy() for k, v in FS.full_model_state_dict(model).items() if v.is_floating_point()},
    }
    if tcfg.fsdp and M.is_sharded(mesh):
        FS.assert_sharded(model, mesh)
        out["bytes"] = FS.local_bytes(model, state.optimizer)
        out["n_dtensor"] = sum(1 for p in model.parameters() if hasattr(p, "full_tensor"))
    return out


class _Dataset:
    """tests/test_torch_port_train.py's in-memory dataset: `get(idx, rng)`
    draws a noise image and 0-3 boxes from the sample's stream."""

    def __init__(self, n, size):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        image = rng.normal(0, 50, (self.size, self.size, 3)).astype(np.float32)
        k = int(rng.integers(0, 4)) if idx % 3 else 1 + idx % 2
        cxy = rng.uniform(0.3, 0.7, (k, 2))
        wh = rng.uniform(0.2, 0.4, (k, 2))
        t = np.zeros((k, 15), np.float32)
        t[:, :2] = cxy - wh / 2
        t[:, 2:4] = cxy + wh / 2
        t[:, 4:14] = np.repeat(cxy, 5, axis=0).reshape(k, 10)
        t[:, 14] = 1.0
        return image, t


def det_fit(payload, mesh):
    """`train.fit` on the synthetic dataset in payload["dir"] (rank 0
    writes), then each rank's parameter fingerprint and the files."""
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    tcfg = TC.TrainConfig(**payload["kw"])
    ds = _Dataset(payload["n"], tcfg.image_size)
    d = payload["dir"]
    mgr = CheckpointManager(os.path.join(d, "ck"))
    state = TT.fit(cfg, tcfg, ds, log_dir=os.path.join(d, "logs"), checkpoint_manager=mgr,
                   device="cpu", mesh=mesh if M.is_sharded(mesh) else None)
    full = FS.full_model_state_dict(state.model)
    return {
        "fingerprint": {k: float(v.double().sum()) for k, v in full.items() if v.is_floating_point()},
        "step": state.step,
        "steps": mgr.all_steps(),
    }


def rec_steps(payload, mesh):
    """Class-sharded recognition steps (recognition/parallel.py) from the
    payload's backbone and head state dicts on its global batches, this
    rank's rows, under a CPU profiler. Returns each step's metrics, the
    gathered state in the single-process layout and the spans inside each
    `jabd.rectrain.step`."""
    from jabd_tpu_torch.recognition import build_head
    from jabd_tpu_torch.recognition import net as TN
    from jabd_tpu_torch.recognition import parallel as RP
    from jabd_tpu_torch.recognition import train as RT

    model = TN.IRBackbone(num_layers=18, mode="ir", dropout=0.0, image_size=payload["size"])
    model.load_state_dict(payload["model"])
    head = build_head(payload["head_type"], class_num=payload["classes"], pad_to=payload.get("pad_to", 0),
                      device="cpu")
    head.load_state_dict(payload["head"])
    state = RT.create_state(model, head, num_train_steps_hint=100, lr=payload["lr"], milestones=(50,))
    step, state = RP.make_sharded_train_step(state, mesh, fsdp=payload.get("fsdp", False))
    metrics = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for images, labels in payload["batches"]:
            if M.is_sharded(mesh):
                images, labels = M.shard_batch((images, labels), mesh)
            state, m = step(state, images, labels)
            metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "state": state.state_dict(), "spans": span_tree(prof, "jabd.rectrain.step")}
    if M.is_sharded(mesh):
        out["head_local"] = tuple(state.head.kernel.shape)
    return out


def rec_cli(payload, mesh):
    """`recognition.cli main(argv)` on this rank."""
    from jabd_tpu_torch.recognition import cli as RC

    RC.main(payload["argv"])
    return {"rank": mesh.rank}


def mesh_facts(payload, mesh):
    """The mesh module's collectives and helpers on this rank: a second
    init_distributed call, replicate_tree, all_reduce_sum / all_gather with
    their gradients, prefetch_to_device's rows."""
    M.init_distributed(payload["address"], mesh.size, mesh.rank)  # tolerated: already initialized
    out = {"initialized": torch.distributed.is_initialized(), "size": mesh.size, "rank": mesh.rank}
    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, float(mesh.rank + 1))
    M.replicate_tree(model, mesh)
    out["weight"] = model.weight.detach().clone()
    x = torch.full((2, 3), float(mesh.rank + 1), requires_grad=True)
    y = M.all_gather(x, mesh)  # [4, 3]: rank 0's rows, then rank 1's
    (y * torch.arange(4.0)[:, None]).sum().backward()  # each rank weighs the gathered rows
    out["gathered"], out["gather_grad"] = y.detach(), x.grad.clone()
    z = torch.tensor([float(mesh.rank + 1)], requires_grad=True)
    s = M.all_reduce_sum(z * z, mesh)
    (s * (mesh.rank + 1)).sum().backward()
    out["sum"], out["sum_grad"] = s.detach(), z.grad.clone()
    batches = [(torch.arange(8.0).reshape(4, 2), None)]
    out["fed"] = [b[0] for b in ST.prefetch_to_device(iter(batches), mesh.device, 2, mesh=mesh)]
    return out
