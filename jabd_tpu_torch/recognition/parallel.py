"""Class-sharded (model-parallel) margin-head training, PartialFC-style.

Port of `jabd_tpu/recognition/parallel.py`. The JAX package annotates the
head kernel [D, C] as sharded along the class axis and lets XLA derive the
schedule; here it is written by hand over a process mesh of N ranks:

  * rank r holds the kernel's columns [r C/N, (r+1) C/N) and their SGD
    momentum; the backbone is a replica (synchronized BatchNorms, its
    gradients summed over the mesh), or FSDP-sharded with `fsdp=True`;
  * the embeddings are all-gathered with their gradient, the norms and
    labels without; each rank computes the cosine of the global batch
    against its columns, [B, C/N];
  * the margin goes to a row's target column on the rank that holds it:
    the target cosine is all-reduced (one rank contributes it, the others
    zeros), the head's own `_delta` is applied there. AdaFace's EMA of the
    norms is taken over the global batch (unbiased std), so every rank
    keeps the same buffers;
  * the softmax's max is all-reduced (no gradient: it only shifts), its
    sum of exponentials and the target logit are all-reduced with their
    gradient, so the cross-entropy is the global batch's on every rank;
  * every rank backpropagates loss / N (parallel/mesh.py's rule), so the
    embedding cotangent is summed over the class shards on its way back.

Uneven class counts are padded at head construction (`build_head(...,
pad_to=mesh size)`; padding columns at -3e4 take no mass and no gradient).
Checkpoints gather the head (and FSDP's shards) into the single-process
layout, which `recognition.cli verify --ckpt` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from jabd_tpu_torch.parallel import fsdp as FS
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.recognition import train as RT


def check_width(width: int, n: int) -> None:
    """ValueError, with the JAX package's text, unless the head's width
    divides the mesh."""
    if width % n:
        raise ValueError(
            f"head kernel class dim {width} does not "
            f"divide across {n} devices — build the head with "
            f"pad_to={n} (build_head(..., pad_to=mesh size); "
            "padding columns are exactly masked)"
        )


def shard_head(head: nn.Module, mesh: M.Mesh) -> nn.Module:
    """Keep this rank's columns of `head.kernel`, in place (`col0`, the
    first global column, and `width`, the global width, are kept beside
    it). ValueError when the width does not divide the mesh."""
    width = head.kernel.shape[1]
    check_width(width, mesh.size)
    w = width // mesh.size
    head.col0, head.width = mesh.rank * w, width
    head.kernel = nn.Parameter(head.kernel.detach()[:, head.col0 : head.col0 + w].clone())
    return head


def sharded_loss(head: nn.Module, emb: torch.Tensor, norms: torch.Tensor, labels: torch.Tensor,
                 mesh: M.Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy, accuracy) of the global batch, the same on every
    rank, from this rank's rows and its columns of the head."""
    emb = M.all_gather(emb.float(), mesh)
    norms = M.all_gather(norms.float().detach(), mesh)
    labels = M.all_gather(labels.long(), mesh)
    with torch.autocast(emb.device.type, enabled=False):
        cosine = head._cosine(emb)  # [B, w]: this rank's columns
        w = cosine.shape[1]
        rel = labels - head.col0
        local = ((rel >= 0) & (rel < w))[:, None]
        idx = rel.clamp(0, w - 1)[:, None]
        tgt = M.all_reduce_sum(torch.where(local, cosine.gather(1, idx), 0.0), mesh)
        delta = head._delta(tgt, norms)
        logits = cosine.scatter_add(1, idx, torch.where(local, delta, 0.0)) * head.s
        pad = head.col0 + torch.arange(w, device=logits.device) >= head.classnum
        logits = logits.masked_fill(pad, -3e4)
        row_max = logits.detach().max(1).values
        shift = M.all_reduce(row_max, mesh, dist.ReduceOp.MAX)
        sumexp = M.all_reduce_sum(torch.exp(logits - shift[:, None]).sum(1), mesh)
        z_t = M.all_reduce_sum(torch.where(local, logits.gather(1, idx), 0.0)[:, 0], mesh)
        loss = (torch.log(sumexp) + shift - z_t).mean()
        # Global argmax, the lowest column among equal maxima (torch.argmax's rule).
        cand = head.col0 + logits.detach().argmax(1)
        cand = torch.where(row_max == shift, cand, torch.iinfo(torch.long).max)
        pred = M.all_reduce(cand, mesh, dist.ReduceOp.MIN)
        acc = (pred == labels).float().mean()
    return loss, acc


@dataclasses.dataclass
class ShardedRecTrainState(RT.RecTrainState):
    """A RecTrainState over a process mesh: `head` holds this rank's
    columns, `model` may be FSDP-sharded. `state_dict` gathers both into
    the single-process layout (a collective: every rank calls it) and
    `load_state_dict` takes that layout."""

    mesh: Optional[M.Mesh] = None

    def head_loss(self, emb: torch.Tensor, norm: torch.Tensor, labels: torch.Tensor):
        """`sharded_loss` of this rank's rows: every rank backpropagates
        loss / N (parallel/mesh.py's rule); the metrics are the global
        batch's."""
        loss, acc = sharded_loss(self.head, emb, norm, labels, self.mesh)
        return loss / self.mesh.size, lambda: {"loss": loss.detach(), "acc": acc}

    def _full(self, p, t):
        if p is self.head.kernel:
            return M.all_gather(t.t().contiguous(), self.mesh).t().contiguous()
        return FS.full_tensor(p, t)

    def _local(self, p, t):
        if p is self.head.kernel:
            return t[:, self.head.col0 : self.head.col0 + p.shape[1]].to(p.device)
        return FS.local_tensor(p, t)

    def state_dict(self) -> Dict:
        head = {k: v for k, v in self.head.state_dict().items()}
        head["kernel"] = self._full(self.head.kernel, self.head.kernel.detach())
        return {
            "model": FS.full_model_state_dict(self.model),
            "head": head,
            "optimizer": FS.full_optimizer_state_dict(self.optimizer, self._full),
            "step": self.step,
        }

    def load_state_dict(self, payload: Dict) -> None:
        FS.load_full_model_state_dict(self.model, payload["model"])
        head = dict(payload["head"])
        head["kernel"] = self._local(self.head.kernel, head["kernel"])
        self.head.load_state_dict(head)
        FS.load_full_optimizer_state_dict(self.optimizer, payload["optimizer"], self._local)
        self.step = int(payload["step"])


def place_state(state: RT.RecTrainState, mesh: M.Mesh, fsdp: bool = False) -> ShardedRecTrainState:
    """The class-sharded layout of a (single-process) state: rank 0's
    backbone and head everywhere, synchronized BatchNorms, this rank's
    columns of the head, FSDP on the backbone with `fsdp`, and a fresh
    optimizer over the placed parameters (momentum follows its
    parameter). ValueError when the head's width does not divide."""
    from jabd_tpu_torch.models.layers import convert_sync_batchnorm

    check_width(state.head.kernel.shape[1], mesh.size)
    convert_sync_batchnorm(state.model, mesh)
    M.replicate_tree(state.model, mesh)
    M.replicate_tree(state.head, mesh)
    shard_head(state.head, mesh)
    if fsdp:
        FS.shard_model(state.model, mesh)
    placed = ShardedRecTrainState(
        model=state.model, head=state.head, optimizer=None, lr=state.lr,
        milestones=state.milestones, gamma=state.gamma, step=state.step, mesh=mesh,
    )
    placed.optimizer = RT.make_optimizer(placed.named_parameters(), state.lr)
    return placed


def make_sharded_train_step(state: RT.RecTrainState, mesh: M.Mesh, fsdp: bool = False,
                            compute_dtype: str = "float32", seed: int = 0):
    """The recognition train step over a process mesh with the head
    sharded along classes. Returns (step, placed state); step(state,
    images [b, S, S, 3], labels [b]) takes this rank's rows of the global
    batch (`parallel.mesh.shard_batch`) and returns the global batch's
    metrics: `recognition.train.make_train_step`'s step over the placed
    state (`ShardedRecTrainState.head_loss`). A mesh of size 1 is the
    plain step and state."""
    placed = place_state(state, mesh, fsdp) if M.is_sharded(mesh) else state
    return RT.make_train_step(1, compute_dtype, seed), placed


def make_sharded_train_step_aug(state: RT.RecTrainState, mesh: M.Mesh, fsdp: bool = False,
                                compute_dtype: str = "float32", seed: int = 0,
                                resample_dtype: torch.dtype = torch.bfloat16):
    """The device-augmented twin: step(state, images_u8, plan, labels),
    each rank augmenting its own rows first."""
    placed = place_state(state, mesh, fsdp) if M.is_sharded(mesh) else state
    return RT.make_train_step_aug(1, compute_dtype, seed, resample_dtype), placed
