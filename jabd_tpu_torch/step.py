"""What the port's training steps and `fit` loops share: the step
engine, the dropout stream, the device feed and the gathered checkpoint.

`run_step` is the one step of the detector (train.py) and of recognition,
plain or class-sharded (recognition/train.py). Its spans (utils/tracing.py:
recorded only while a torch profiler records) are `<prefix>.step` holding,
per microbatch chunk, [augment] forward <loss phase> backward, then
[allreduce] optimizer; forward, the loss phase, backward and optimizer
time the card's stream. `augment` is the family's, in its `make_images`.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch

from jabd_tpu_torch.parallel import fsdp as FS
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.utils import tracing as T


def dropout_seed(seed: int, step: int) -> int:
    """The dropout stream of train step `step` under `seed`, one per
    (seed, step) as the JAX package's fold_in(PRNGKey(seed), step)
    (whose draws torch cannot reproduce)."""
    return (seed << 32) + step


def run_step(state, make_images: Callable[[slice], torch.Tensor], batch: int, forward: Callable, loss: Callable, *,
             prefix: str, loss_phase: str = "loss", microbatches: int = 1, mesh: Optional[M.Mesh] = None,
             bf16: bool = False, seed: int = 0, dropout: bool = False,
             metric_shares: bool = False) -> Dict[str, torch.Tensor]:
    """One update of `state` (`.model`, `.optimizer`, `.step`,
    `.apply_gradients()`) on `batch` rows; returns the metrics as 0-d
    device tensors and leaves the gradients in `.grad`.

    Per chunk of `microbatches` (ghost BatchNorm: statistics carry from
    chunk to chunk): `make_images(part)` gives its rows [n, H, W, 3],
    `forward(x NCHW, generator)` runs under autocast to bfloat16 with
    `bf16`, and `loss(out, part)` returns (the loss to backpropagate, a
    call giving the chunk's metrics once backward has run). Over chunks
    the summed gradients are divided by their count and the metrics are
    their means; one chunk's are taken as they are. Raises ValueError
    when the batch does not divide.

    With `dropout` a chunk's masks come from a torch.Generator on the
    images' device seeded with `dropout_seed(seed, (state.step * mb + i) *
    n + r)`, rank r of a mesh of n (n = 1, r = 0 off a mesh).

    Over a process mesh of size > 1 the gradients of the replicated
    parameters are summed over it (FSDP reduce-scatters the ones it
    shards), and so are the metrics with `metric_shares` (each rank's are
    its share of the global batch's)."""
    mb = max(microbatches, 1)  # <= 1: the whole batch, as in JAX
    if batch % mb:
        raise ValueError(f"batch {batch} not divisible by microbatches={mb}")
    mesh = mesh if M.is_sharded(mesh) else None
    ranks, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    n = batch // mb
    with T.span(f"{prefix}.step"):
        state.optimizer.zero_grad(set_to_none=True)
        chunks = []
        for i in range(mb):
            part = slice(i * n, (i + 1) * n)
            images = make_images(part)
            dev = images.device
            with T.span(f"{prefix}.forward", dev):
                x = images.permute(0, 3, 1, 2)
                generator = None
                if dropout:
                    stream = (state.step * mb + i) * ranks + rank
                    generator = torch.Generator(dev).manual_seed(dropout_seed(seed, stream))
                with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
                    out = forward(x, generator)
            with T.span(f"{prefix}.{loss_phase}", dev):
                value, metrics = loss(out, part)
            with T.span(f"{prefix}.backward", dev):
                value.backward()  # adds into .grad
            chunks.append(metrics())
        if mesh is not None:
            with T.span(f"{prefix}.allreduce"):
                M.all_reduce_grads(FS.replicated_parameters(state.model), mesh)
                if metric_shares:
                    keys = list(chunks[0])
                    summed = M.all_reduce(torch.stack([torch.stack([c[k] for k in keys]) for c in chunks]), mesh)
                    chunks = [dict(zip(keys, row)) for row in summed]
        with T.span(f"{prefix}.optimizer", dev):
            if mb == 1:
                metrics = chunks[0]
            else:
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(mb)
                metrics = {k: torch.stack([c[k] for c in chunks]).mean() for k in chunks[0]}
            state.apply_gradients()
    return metrics


def _to_device(x, device: torch.device, moved: list):
    """Copy a batch's tensors (in tuples and NamedTuples, or None) to
    `device`, non-blocking from pinned memory when it is a card; the copies
    are appended to `moved`."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if device.type == "cuda":
            x = x.pin_memory()
        moved.append(x.to(device, non_blocking=True))
        return moved[-1]
    if isinstance(x, tuple):
        parts = (_to_device(v, device, moved) for v in x)
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    raise TypeError(f"cannot move {type(x).__name__} to a device")


def prefetch_to_device(iterator, device, depth: int = 2, mesh: Optional[M.Mesh] = None, chunks: int = 1):
    """Keep `depth` batches in flight on `device`: each batch (tuples and
    NamedTuples of CPU tensors, or None) is copied before the one ahead of
    it is yielded. Port of jabd_tpu/parallel/mesh.py:132-153 (the
    reference DataLoader's pin_memory). Over a process mesh of size > 1
    each global batch is first cut to this process's rows
    (`parallel.mesh.shard_batch`, `chunks` for microbatches).

    On a card the copies run from pinned host memory on a stream of their
    own, so the copy of batch i + 1 overlaps step i on the current stream;
    the current stream waits for a batch's copies only when it is yielded,
    and the copied tensors are recorded on it for the caching allocator."""
    if M.is_sharded(mesh):
        iterator = (M.shard_batch(b, mesh, chunks) for b in iterator)
    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue = collections.deque()

    def ready(entry):
        batch, moved, done = entry
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for t in moved:
                t.record_stream(compute)
        return batch

    for batch in iterator:
        moved = []
        if copy_stream is None:
            queue.append((_to_device(batch, device, moved), moved, None))
        else:
            with torch.cuda.stream(copy_stream):
                batch = _to_device(batch, device, moved)
                queue.append((batch, moved, copy_stream.record_event()))
        if len(queue) >= depth:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())


class _Payload:
    """A state dict already gathered, for CheckpointManager.save."""

    def __init__(self, payload: Dict):
        self.payload = payload

    def state_dict(self) -> Dict:
        return self.payload


def save_checkpoint(manager, step: int, state, mesh: Optional[M.Mesh] = None) -> None:
    """Checkpoint `state` as step `step` through `manager`
    (utils/checkpoint.CheckpointManager): its state dict gathered on every
    rank (a collective under a sharded state), written by rank 0, then a
    barrier over the mesh."""
    payload = state.state_dict()
    if mesh is None or mesh.rank == 0:
        manager.save(step, _Payload(payload))
    M.barrier(mesh)
