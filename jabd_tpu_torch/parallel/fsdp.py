"""FSDP over the data mesh under the JAX package's leaf rule.

Port of `jabd_tpu/parallel/fsdp.py`. The JAX package shards each large
parameter, and through the same rule its Adam moments, along its largest
mesh-divisible axis and lets GSPMD gather the weights where the forward
reads them and reduce-scatter the gradients. Here FSDP2
(`torch.distributed.fsdp.fully_shard`) does the same over a process mesh:
`shard_placement_fn` places each parameter at `leaf_spec`'s axis, the
leaves the rule replicates stay out of the sharded groups
(`ignored_params`; the train step all-reduces their gradients), and the
optimizer built over the sharded parameters keeps its moments sharded
with them. Gradients are summed over the mesh, not averaged
(`set_gradient_divide_factor(1)`, SUM on the wire), as every sharded path
of the port sums them (parallel/mesh.py).

`leaf_spec` is the JAX rule copied exactly, on the shape it is given: a
port parameter's layout (OIHW, [out, in]) permutes the flax one's (HWIO,
[in, out]), so the sharded dimension has the same size, though its index
may differ.

Checkpoints gather the full state (`full_model_state_dict`,
`full_optimizer_state_dict`) in the single-process layout, with the
mesh's own all-reduce (`full_tensor`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from jabd_tpu_torch.parallel.mesh import Mesh, all_gather

# Leaves smaller than this stay replicated: sharding a [C]-sized BN
# vector saves nothing and costs an all-gather per use. 8192 f32 = 32 KB.
MIN_SHARD_SIZE = 8192


def leaf_spec(shape, n_shards: int, min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The axis of `shape` to shard over n_shards (its LARGEST n-divisible
    axis, the first of equals), or None when the leaf is replicated (too
    small, or no axis divides)."""
    shape = tuple(shape)
    if math.prod(shape) < min_size:
        return None
    divisible = [d for d in range(len(shape)) if shape[d] % n_shards == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda d: shape[d])


def _device_mesh(mesh: Mesh):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(mesh.group, mesh.device.type)


def shard_model(model: torch.nn.Module, mesh: Mesh, min_size: int = MIN_SHARD_SIZE) -> torch.nn.Module:
    """Apply FSDP2 to `model` in place over a process mesh of size > 1 (a
    smaller mesh leaves it as it is): every parameter `leaf_spec` shards
    becomes a DTensor holding 1/N of it on each rank; the rest are
    `ignored_params`, replicated. Build the optimizer afterwards."""
    if not (mesh.is_process_mesh and mesh.size > 1):
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size
    ignored = {p for p in model.parameters() if leaf_spec(p.shape, n, min_size) is None}
    fully_shard(
        model,
        mesh=_device_mesh(mesh),
        reshard_after_forward=True,
        shard_placement_fn=lambda p: Shard(leaf_spec(p.shape, n, min_size)),
        ignored_params=ignored,
    )
    # Sums, with SUM itself on the wire: gloo takes neither AVG nor the
    # PREMUL_SUM a divide factor otherwise becomes.
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)
    return model


def replicated_parameters(model: torch.nn.Module):
    """The parameters FSDP does not shard (all of them without FSDP): the
    ones whose gradients the step all-reduces itself."""
    from torch.distributed.tensor import DTensor

    return [p for p in model.parameters() if not isinstance(p, DTensor)]


def foreach_flag(params) -> Optional[bool]:
    """An optimizer's `foreach`: torch's default (None), or False when the
    parameters mix DTensors (sharded) and plain tensors (replicated), which
    one foreach kernel refuses on a card."""
    from torch.distributed.tensor import DTensor

    kinds = {isinstance(p, DTensor) for p in params}
    return False if len(kinds) > 1 else None


def local_numel(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor

    return t.to_local().numel() if isinstance(t, DTensor) else t.numel()


def assert_sharded(model: torch.nn.Module, mesh: Mesh, min_size: int = MIN_SHARD_SIZE) -> None:
    """Every parameter the rule shards holds 1/mesh of its elements on this
    rank; AssertionError naming the first that does not."""
    for name, p in model.named_parameters():
        if leaf_spec(p.shape, mesh.size, min_size) is None:
            continue
        local = local_numel(p)
        if local * mesh.size != p.numel():
            raise AssertionError(
                f"{name}: expected 1/{mesh.size} shards, got {local} of {p.numel()} elements"
            )


def local_bytes(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Bytes of parameters (and optimizer state) this rank holds."""
    total = sum(local_numel(p) * p.element_size() for p in model.parameters())
    if optimizer is not None:
        for st in optimizer.state.values():
            total += sum(local_numel(v) * v.element_size() for v in st.values() if torch.is_tensor(v))
    return total


def full_tensor(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t` (a parameter `p`'s value, gradient or optimizer state) whole: a
    DTensor's shards gathered along their dim with the mesh's all-reduce
    (`parallel.mesh.all_gather`; a collective, every rank calls it in the
    same order), anything else as it is. DTensor.full_tensor's functional
    collectives crash under gloo on CUDA tensors (torch 2.11, PERF.md)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    group = t.device_mesh.get_group()
    mesh = Mesh([t.device], group=group, size=dist.get_world_size(group), rank=dist.get_rank(group))
    d = t.placements[0].dim
    local = t.to_local().detach().movedim(d, 0).contiguous()
    return all_gather(local, mesh).movedim(0, d).contiguous()


def local_tensor(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The inverse of `full_tensor`: this rank's shard of a whole `t` when
    `p` is a DTensor (no communication), `t` itself else."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return t
    d = p.placements[0].dim
    group = p.device_mesh.get_group()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    chunk = t.to(p.device).chunk(n, dim=d)[r].contiguous()
    return DTensor.from_local(chunk, p.device_mesh, p.placements, run_check=False)


def full_model_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full state dict, the single-process names and shapes, on
    every rank (a collective under FSDP: every rank calls it)."""
    return {k: full_tensor(v, v) for k, v in model.state_dict().items()}


def load_full_model_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load the single-process layout, each sharded entry cut to this
    rank's shard."""
    current = model.state_dict()
    model.load_state_dict({k: local_tensor(current[k], v) for k, v in state.items()})


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer, full=full_tensor) -> Dict:
    """The optimizer's state dict with every state tensor whole, in the
    single-process layout (`full(param, tensor)`; every rank calls it, in
    the same order)."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd["state"] = {
        i: {k: full(params[i], v) if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
        for i, st in sd["state"].items()
    }
    return sd


def load_full_optimizer_state_dict(optimizer: torch.optim.Optimizer, state: Dict, local=local_tensor) -> None:
    """Load the single-process layout, each state tensor cut to this rank's
    shard of its parameter (`local(param, tensor)`)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = dict(state)
    state["state"] = {
        i: {k: local(params[i], v) if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
        for i, st in state["state"].items()
    }
    optimizer.load_state_dict(state)
