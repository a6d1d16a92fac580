"""The 1-D data mesh of the port, and the collectives its sharded paths use.

Port of `jabd_tpu/parallel/mesh.py`. In JAX one SPMD program spans the
mesh and XLA inserts the collectives; here the port writes them, over two
kinds of mesh:

  * a PROCESS mesh (training): one process per card under
    `torch.distributed` (torchrun, or `parallel/spawn.py`). `size` is the
    world size, `rank` this process's rank, `devices` the one device this
    process computes on. Every rank builds the same global batch from the
    seed and keeps its own rows (`shard_batch`), as the JAX package's
    `device_put_global` contract has every host do;
  * a LOCAL mesh (serving, extraction): a list of `torch.device`s in one
    process, one model replica per entry, each batch split across them
    (the reference's `nn.DataParallel` serving wrap). An entry may repeat
    (`[cuda:0, cuda:0]`, `[cpu, cpu]`): each gets its own replica, which
    holds the batch split on a machine with one card.

A mesh of size 1 is the plain path, as `mesh.size > 1 else None` is
throughout the JAX package.

The collectives with a gradient follow one rule: the objective of a step
is the SUM over ranks of what each rank backpropagates, so the autograd of
an all-reduce is an all-reduce (`all_reduce_sum`), that of an all-gather
the all-reduce of the cotangent and this rank's rows of it (`all_gather`),
and gradients of replicated parameters are summed over the mesh
(`all_reduce_grads`). A step whose loss is the same global value on every
rank backpropagates loss / size.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

class Mesh:
    """A 1-D data mesh: a process group (`group` set; this process is
    `rank` of `size` and computes on `devices[0]`) or local devices
    (`group` None; `rank` 0, `size` = len(devices))."""

    def __init__(self, devices: Sequence, group=None, size: Optional[int] = None, rank: int = 0):
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.size = int(size if size is not None else len(self.devices))
        self.rank = int(rank)

    @property
    def is_process_mesh(self) -> bool:
        return self.group is not None

    @property
    def device(self) -> torch.device:
        """The device this process computes on (the first local entry)."""
        return self.devices[0]

    def __repr__(self) -> str:
        kind = "process" if self.is_process_mesh else "local"
        return f"Mesh({kind}, size={self.size}, rank={self.rank}, devices={self.devices})"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group: `dist.init_process_group` with NCCL when
    there is a card, gloo without one (or `backend`), at
    `coordinator_address` ("host:port", "tcp://host:port" or
    "file:///path"). Without arguments it reads torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR/MASTER_PORT. One process (no coordinator,
    num_processes None or 1, no WORLD_SIZE > 1) is a no-op, and a second
    call on an initialized group is tolerated, as in the JAX package;
    everything else propagates: there is no silent single-process
    fallback."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes in (None, 1) and env_world <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
        num_processes = env_world if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a coordinator address")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id, **kwargs)


def process_mesh(device=None) -> Mesh:
    """The mesh of the initialized process group, this process computing
    on `device` (its card unless given: cuda:LOCAL_RANK under NCCL, the
    current card else). Without a group, a mesh of size 1."""
    if device is None:
        from jabd_tpu_torch import resolve_device

        device = resolve_device(None)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh([device])
    return Mesh([device], group=dist.group.WORLD, size=dist.get_world_size(), rank=dist.get_rank())


def local_devices() -> list:
    """Each local card once. Raises without a card, as `resolve_device`."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the mesh's devices (e.g. ['cpu', 'cpu'])")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Local data mesh over `devices` (an entry may repeat), or over each
    local card once."""
    return Mesh(list(devices) if devices is not None else local_devices())


def make_mesh_for_batch(batch_size: int, devices: Optional[Sequence] = None) -> Mesh:
    """Largest local mesh whose device count divides batch_size (a sharded
    batch axis must split evenly across the mesh)."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return Mesh(devices[:n])


def check_divisible(batch: int, mesh: Mesh, chunks: int = 1) -> None:
    """ValueError unless each of `chunks` chunks of `batch` splits evenly
    over the mesh (the JAX loss's sharded-matching check)."""
    if batch % chunks or (batch // chunks) % mesh.size:
        raise ValueError(
            f"batch {batch // max(chunks, 1)} (per loss call — the microbatch chunk when "
            f"microbatches>1) must divide the mesh size {mesh.size} for sharded matching; "
            f"adjust the batch"
        )


def rank_rows(batch: int, mesh: Mesh, rank: Optional[int] = None, chunks: int = 1) -> np.ndarray:
    """Global row indices rank `rank` (this process's by default) holds.
    With `chunks` > 1 (microbatches) each chunk c, the global rows
    [c B/m, (c+1) B/m), is split over the mesh and the rank takes its slice
    of every chunk, so that chunk c of its rows is its shard of the global
    chunk c, as the JAX package's microbatch scan over a sharded batch."""
    check_divisible(batch, mesh, chunks)
    rank = mesh.rank if rank is None else rank
    per_chunk = batch // chunks
    n = per_chunk // mesh.size
    return np.concatenate([np.arange(c * per_chunk + rank * n, c * per_chunk + (rank + 1) * n) for c in range(chunks)])


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple):
        parts = [_map(fn, v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    raise TypeError(f"cannot shard {type(tree).__name__}")


def _leading(tree) -> int:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree.shape[0]
    for v in tree.values() if isinstance(tree, dict) else tree:
        if v is not None:
            return _leading(v)
    raise ValueError("empty batch")


def shard_batch(batch: Any, mesh: Mesh, chunks: int = 1) -> Any:
    """This process's rows of every array in `batch` (tensors and numpy
    arrays in tuples, NamedTuples, lists and dicts), the leading axis
    sharded over a process mesh (`rank_rows`). On a local mesh, a list of
    one piece per entry, each on its device."""
    b = _leading(batch)
    if mesh.is_process_mesh:
        if mesh.size == 1:
            return batch
        rows = rank_rows(b, mesh, chunks=chunks)
        return _map(lambda x: x[torch.from_numpy(rows)] if isinstance(x, torch.Tensor) else x[rows], batch)
    check_divisible(b, mesh, chunks)
    return [
        _map(lambda x, r=r, d=d: torch.as_tensor(x[rank_rows(b, mesh, r, chunks)]).to(d), batch)
        for r, d in enumerate(mesh.devices)
    ]


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values everywhere. On a process mesh every tensor of a
    module's state dict (or of a dict or list of tensors) is broadcast from
    rank 0 in place and `tree` is returned; on a local mesh, a list of one
    copy per entry, on its device (a module deep-copied)."""
    if not mesh.is_process_mesh:
        import copy

        if isinstance(tree, torch.nn.Module):
            return [copy.deepcopy(tree).to(d) for d in mesh.devices]
        return [_map(lambda x, d=d: torch.as_tensor(x).to(d), tree) for d in mesh.devices]
    if mesh.size == 1:
        return tree
    tensors = tree.state_dict().values() if isinstance(tree, torch.nn.Module) else _flatten(tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0, group=mesh.group)
    return tree


def _flatten(tree) -> list:
    out = []
    _map(lambda x: out.append(x), tree)
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def is_local_sharded(mesh: Optional[Mesh]) -> bool:
    """A local mesh of size > 1: the replicated serving paths run."""
    return mesh is not None and not mesh.is_process_mesh and mesh.size > 1


def is_sharded(mesh: Optional[Mesh]) -> bool:
    """A process mesh of size > 1: the sharded paths run; else the plain one."""
    return mesh is not None and mesh.is_process_mesh and mesh.size > 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of `x` over the mesh, differentiable (backward: the sum of the
    cotangents). The identity on a mesh of size 1 or None."""
    if not is_sharded(mesh):
        return x
    if not x.requires_grad:
        return all_reduce(x, mesh)
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of `x` (no gradient)."""
    y = x.detach().clone()
    if is_sharded(mesh):
        dist.all_reduce(y, op=op, group=mesh.group)
    return y


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenation of every rank's `x` along dim 0 (equal shapes), as an
    all-reduce of zero-padded buffers: adding zeros is exact, and an
    all-reduce is the collective every backend takes for every device."""
    out = torch.zeros((mesh.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.rank * x.shape[0] : (mesh.rank + 1) * x.shape[0]] = x
    dist.all_reduce(out, group=mesh.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _gather(x.detach(), mesh)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        r = ctx.mesh.rank
        return g[r * ctx.n : (r + 1) * ctx.n], None


def all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows of `x`, concatenated in rank order; differentiable
    (backward: this rank's rows of the summed cotangent)."""
    if not is_sharded(mesh):
        return x
    if not x.requires_grad:
        return _gather(x, mesh)
    return _AllGather.apply(x, mesh)


def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the `.grad` of every parameter over the mesh, in one bucket
    (gradients of replicated parameters; the FSDP-sharded ones are
    reduce-scattered by FSDP)."""
    if not is_sharded(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier(mesh: Optional[Mesh]) -> None:
    if is_sharded(mesh):
        dist.barrier(group=mesh.group)
