"""Recognition training and evaluation: the SGD train step, `fit`, and
flip-TTA extraction with the 5-set verification.

Port of `jabd_tpu/recognition/train.py`, the reference's recipe
(train_val.py, main.py):

  * model(images) -> (embedding, norm); head(embedding, norm, labels) ->
    scaled margin logits; cross-entropy over them (train_val.py:52-70);
  * SGD with momentum 0.9 and weight decay 5e-4 on every parameter but
    the BatchNorms' (split_parameters, train_val.py:204-233): PReLU
    alphas, biases and the head's kernel are decayed. torch's SGD adds the
    decay to the gradient and starts its momentum at the first gradient,
    which is optax.chain(add_decayed_weights, trace, scale_by_learning_rate);
  * the learning rate of update `count` is lr * gamma ** (the number of
    milestones <= count), optax.piecewise_constant_schedule's rule, set
    before each update (`RecTrainState.lr_at`);
  * validation with horizontal-flip TTA and 10-fold verification.

The step runs eagerly and updates the state in place, the backbone and
the head in training mode: BatchNorm statistics with flax's running
variance, AdaFace's norm EMA, dropout from a torch.Generator seeded per
(seed, step, microbatch chunk) (`step.dropout_seed`: the same draws on
every resume, not the JAX package's). With
compute_dtype "bfloat16" (`--precision 16`) the backbone runs under
torch.autocast while its parameters, the head and the loss stay float32.
Every batch of an extraction, the tail included, is padded to
`batch_size`, so a sweep runs one shape; over a local mesh (`mesh=`) each
padded batch is split across one replica per mesh entry. Training with
the head sharded over a process mesh is `recognition/parallel.py`, which
`fit(mesh=)` drives.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch import step as ST
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.recognition import identification as ID
from jabd_tpu_torch.recognition import verification as V
from jabd_tpu_torch.utils import tracing as T

# Steps a loop may run ahead of the host before it waits for an old loss.
MAX_IN_FLIGHT = 3


def _is_bn_param(name: str) -> bool:
    """Only BatchNorm parameters skip the weight decay: a dotted name with
    a component containing "bn" (the reference's split_parameters)."""
    return any("bn" in part for part in name.split("."))


def make_optimizer(
    named_params: Sequence[Tuple[str, torch.nn.Parameter]],
    lr: float,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
) -> torch.optim.SGD:
    """SGD with momentum, two groups: decayed (every name `_is_bn_param`
    rejects) and not decayed."""
    from jabd_tpu_torch.parallel.fsdp import foreach_flag

    decay = [p for n, p in named_params if not _is_bn_param(n)]
    no_decay = [p for n, p in named_params if _is_bn_param(n)]
    return torch.optim.SGD(
        [{"params": decay, "weight_decay": weight_decay}, {"params": no_decay, "weight_decay": 0.0}],
        lr=lr, momentum=momentum, dampening=0.0, nesterov=False, foreach=foreach_flag(decay + no_decay),
    )


@dataclasses.dataclass
class RecTrainState:
    """Backbone, head, optimizer and schedule; `step` counts the updates,
    which the schedule reads (the JAX state's step and optax count)."""

    model: torch.nn.Module
    head: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr: float
    milestones: Tuple[int, ...]
    gamma: float = 0.1
    step: int = 0
    # The process mesh the step reduces over: a field of the class-sharded
    # state (recognition/parallel.ShardedRecTrainState); none here.
    mesh = None

    def named_parameters(self):
        return [(f"model.{n}", p) for n, p in self.model.named_parameters()] + [
            (f"head.{n}", p) for n, p in self.head.named_parameters()
        ]

    def lr_at(self, count: int) -> float:
        return self.lr * self.gamma ** sum(1 for m in self.milestones if m <= count)

    def head_loss(self, emb: torch.Tensor, norm: torch.Tensor, labels: torch.Tensor):
        """A step's head phase: (the cross-entropy of the margin logits,
        a call giving the metrics once backward has run). The head stays
        float32 (outside autocast) under bf16."""
        logits = self.head(emb.float(), norm.float(), labels)
        loss = F.cross_entropy(logits, labels.long())
        return loss, lambda: {"loss": loss.detach(), "acc": (logits.detach().argmax(-1) == labels).float().mean()}

    def apply_gradients(self) -> None:
        """One SGD update with the gradients in `.grad`, at the lr of the
        current count."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> Dict:
        """The backbone's state dict under "model" (what `recognition.cli
        verify --ckpt` reads), the head's, the optimizer's and the step."""
        return {
            "model": self.model.state_dict(),
            "head": self.head.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, payload: Dict) -> None:
        self.model.load_state_dict(payload["model"])
        self.head.load_state_dict(payload["head"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])


def create_state(
    model: torch.nn.Module,
    head: torch.nn.Module,
    num_train_steps_hint: int,
    lr: float = 0.1,
    milestones: Optional[Sequence[int]] = None,
    gamma: float = 0.1,
) -> RecTrainState:
    """The train state of `model` and `head` (on the device they are on).
    `milestones` are update counts; without them, the AdaFace recipe's
    epochs 12 / 20 / 24 of 26 scaled to `num_train_steps_hint`. Raises
    ValueError unless the milestones increase strictly: the JAX package
    lets scaled milestones collide (hint <= 4) and then drops decays."""
    if milestones is None:
        milestones = tuple(max(1, int(num_train_steps_hint * e / 26)) for e in (12, 20, 24))
    milestones = tuple(int(m) for m in milestones)
    if any(b <= a for a, b in zip(milestones, milestones[1:])):
        raise ValueError(
            f"lr milestones {milestones} must increase strictly (num_train_steps_hint "
            f"{num_train_steps_hint}); equal milestones would drop a decay"
        )
    state = RecTrainState(model=model, head=head, optimizer=None, lr=lr, milestones=milestones, gamma=gamma)
    state.optimizer = make_optimizer(state.named_parameters(), lr)
    return state


def make_train_step(microbatches: int = 1, compute_dtype: str = "float32", seed: int = 0):
    """step(state, images [B, S, S, 3] float32, labels [B] int) -> (state,
    metrics {"loss", "acc"} as 0-d device tensors): train-mode forward,
    `state.head_loss` (the margin head on float32 embeddings and
    cross-entropy), backward, one SGD update (`step.run_step`). Images and
    labels lie on the model's device. Over a `ShardedRecTrainState`
    (recognition/parallel.py) they are this rank's rows and the step is
    the class-sharded one, over the state's mesh.

    `microbatches` > 1 (accumulate_grad_batches, main.py:40-50): each
    chunk has its own forward and backward; BatchNorm normalizes per chunk
    (ghost BN) and AdaFace's norm EMA carries from chunk to chunk. Raises
    ValueError when the batch does not divide.

    Each step opens a `jabd.rectrain.step` span (`step.run_step`; the loss
    phase `jabd.rectrain.head`)."""
    return _make_step(microbatches, compute_dtype, seed, augment=None)


def make_train_step_aug(
    microbatches: int = 1, compute_dtype: str = "float32", seed: int = 0,
    resample_dtype: torch.dtype = torch.bfloat16,
):
    """The device-augmented twin of make_train_step: step(state, images_u8
    [B, S, S, 3] uint8, plan, labels) with a `device_augment.FaceAugmentPlan`
    on the images' device; each chunk augments its own slice first
    (`device_augment_faces`, no gradient)."""
    from jabd_tpu_torch.recognition.device_augment import device_augment_faces

    def augment(images_u8, plan, part):
        with torch.no_grad(), T.span("jabd.rectrain.augment"):
            return device_augment_faces(images_u8[part], type(plan)(*(t[part] for t in plan)), resample_dtype)

    return _make_step(microbatches, compute_dtype, seed, augment=augment)


def _make_step(microbatches: int, compute_dtype: str, seed: int, augment):
    def run(state: RecTrainState, make_images, labels):
        state.model.train()
        state.head.train()
        metrics = ST.run_step(
            state, make_images, labels.shape[0], lambda x, generator: state.model(x, generator=generator),
            lambda out, part: state.head_loss(*out, labels[part]), prefix="jabd.rectrain", loss_phase="head",
            microbatches=microbatches, mesh=state.mesh, bf16=compute_dtype == "bfloat16",
            seed=seed, dropout=state.model.dropout > 0.0,
        )
        return state, metrics

    if augment is None:

        def step(state: RecTrainState, images: torch.Tensor, labels: torch.Tensor):
            return run(state, lambda part: images[part], labels)

        return step

    def aug_step(state: RecTrainState, images_u8: torch.Tensor, plan, labels: torch.Tensor):
        return run(state, lambda part: augment(images_u8, plan, part), labels)

    return aug_step


def fit(
    state: RecTrainState,
    step_fn,
    ds,
    batch_size: int,
    epochs: int,
    *,
    device_augment: bool = False,
    seed: int = 0,
    val_dir: str = "",
    checkpoint_dir: str = "",
    save_period: int = 1,
    max_to_keep: int = 3,
    resume: bool = True,
    log=print,
    device=None,
    mesh: Optional[M.Mesh] = None,
) -> RecTrainState:
    """The reference's Lightning Trainer around the step (main.py:15-62) on
    `device` (the card unless given): epochs of batches from
    `data.recognition_train_loader` or, with `device_augment`,
    `device_augment.device_face_train_loader`, copied ahead through
    `step.prefetch_to_device`; the host waits for the loss of the step
    MAX_IN_FLIGHT back, so it never runs further ahead. Per epoch:
    flip-TTA validation on the sets under `val_dir`, a checkpoint
    (`utils/checkpoint.CheckpointManager`, optimizer included) every
    `save_period` epochs and at the last, a copy under
    `<checkpoint_dir>/best` with `best_meta.json` when val_acc improves,
    and a row of `<checkpoint_dir>/metrics.csv` (epoch,step,loss,acc,
    val_acc). Resumes from the latest checkpoint unless resume is False.

    Over a process mesh of size > 1 (`mesh`, with the step and state of
    `recognition/parallel.make_sharded_train_step`) every rank loads the
    same global batches and keeps its rows; every rank validates (an FSDP
    backbone's forward needs them all), rank 0 alone logs and writes the
    files, the checkpoints in the single-process layout."""
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    dev = resolve_device(device)
    sharded = M.is_sharded(mesh)
    lead = not sharded or mesh.rank == 0
    if sharded:
        M.check_divisible(batch_size, mesh)
    else:
        mesh = None
    say = log if lead else (lambda *a, **k: None)
    if device_augment:
        from jabd_tpu_torch.recognition.device_augment import device_face_train_loader as loader
    else:
        from jabd_tpu_torch.recognition.data import recognition_train_loader as loader

    mgr = best_mgr = None
    best_meta_path = metrics_path = None
    best_acc = -1.0
    start_epoch = 0
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
        best_mgr = CheckpointManager(os.path.join(checkpoint_dir, "best"), max_to_keep=1)
        best_meta_path = os.path.join(checkpoint_dir, "best_meta.json")
        metrics_path = os.path.join(checkpoint_dir, "metrics.csv")
        if os.path.exists(best_meta_path):
            with open(best_meta_path) as f:
                best_acc = float(json.load(f).get("val_acc", -1.0))
        if resume and mgr.latest_step() is not None:
            state = mgr.restore(state)
            start_epoch = int(mgr.latest_step())
            say(f"resumed from checkpoint at epoch {start_epoch}")
        if lead and not os.path.exists(metrics_path):
            with open(metrics_path, "w") as f:
                f.write("epoch,step,loss,acc,val_acc\n")

    for epoch in range(start_epoch + 1, epochs + 1):
        t0 = time.perf_counter()
        losses, accs = [], []
        synced = 0
        batches = (
            tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in batch)
            for batch in loader(ds, batch_size, seed=seed + epoch)
        )
        for batch in ST.prefetch_to_device(batches, dev, 2, mesh=mesh):
            state, m = step_fn(state, *batch)
            losses.append(m["loss"])
            accs.append(m["acc"])
            if len(losses) - synced > MAX_IN_FLIGHT:
                losses[synced].item()
                synced += 1
        loss = float(torch.stack(losses).mean()) if losses else math.nan
        acc = float(torch.stack(accs).mean()) if accs else math.nan
        say(f"epoch {epoch}/{epochs}: loss={loss:.4f} acc={acc:.4f} "
            f"({time.perf_counter() - t0:.2f} s, {len(losses)} steps)")

        val_acc = None
        if val_dir:
            out = validate_5sets(state.model, val_dir, device=dev)
            val_acc = out["mean"]["val_acc"]
            say(json.dumps(out))
        if metrics_path and lead:
            with open(metrics_path, "a") as f:
                f.write(f"{epoch},{state.step},{loss:.6f},{acc:.6f},"
                        f"{'' if val_acc is None else f'{val_acc:.6f}'}\n")
        if mgr and (epoch % save_period == 0 or epoch == epochs):
            ST.save_checkpoint(mgr, epoch, state, mesh)
        if best_mgr and val_acc is not None and val_acc > best_acc:
            best_acc = val_acc
            ST.save_checkpoint(best_mgr, epoch, state, mesh)
            if lead:
                with open(best_meta_path, "w") as f:
                    json.dump({"epoch": epoch, "val_acc": val_acc}, f)
            say(f"new best val_acc {val_acc:.4f} at epoch {epoch}")
    return state


def extract_embeddings_tta(
    model,
    images: np.ndarray,  # [N, H, W, 3] float32 normalized
    batch_size: int = 256,
    fusion_method: str = "pre_norm_vector_add",
    use_flip_test: bool = True,
    faceness_scores: Optional[np.ndarray] = None,  # [N] detector scores
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip-TTA embeddings of `images` through the IR `model` on `device`
    (the card unless given): each batch and its copy flipped along W are
    embedded and fused by `fusion_method`
    (`identification.fuse_features_with_norm`). Returns ([N, 512]
    embeddings, [N, 1] norms).

    `mesh`: a local mesh (parallel/mesh.py) of size > 1 splits each padded
    batch across one replica of the model per mesh entry (ValueError when
    batch_size does not divide the mesh size)."""
    if M.is_local_sharded(mesh):
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} must divide mesh size {mesh.size}")
        replicas = [m.eval() for m in M.replicate_tree(model, mesh)]
    else:
        replicas = [model.to(resolve_device(device)).eval()]
        mesh = M.Mesh([next(replicas[0].parameters()).device])

    def embed(xs, flip: bool):
        """Each replica's rows, launched on every device before any is read."""
        outs = []
        for m, x in zip(replicas, M.shard_batch(xs, mesh)):
            x = x.permute(0, 3, 1, 2)
            outs.append(m(torch.flip(x, dims=(3,)) if flip else x))
        return [np.concatenate([o[i].cpu().numpy() for o in outs]) for i in range(2)]

    embs, norms = [], []
    for lo in range(0, len(images), batch_size):
        xs = np.asarray(images[lo : lo + batch_size], np.float32)
        nb = len(xs)
        if nb < batch_size:  # pad the tail: one shape for the whole sweep
            xs = np.concatenate([xs, np.zeros((batch_size - nb, *xs.shape[1:]), xs.dtype)])
        xs = torch.from_numpy(xs)
        with torch.inference_mode():
            e1, n1 = (t[:nb] for t in embed(xs, False))
            if not use_flip_test:
                embs.append(e1)
                norms.append(n1)
                continue
            e2, n2 = (t[:nb] for t in embed(xs, True))
        fs = faceness_scores[lo : lo + batch_size] if faceness_scores is not None else None
        fused, fused_norm = ID.fuse_features_with_norm(
            np.stack([e1, e2]), np.stack([n1, n2]), fusion_method=fusion_method, faceness_scores=fs
        )
        embs.append(fused)
        norms.append(fused_norm)
    return np.concatenate(embs), np.concatenate(norms)


def extract_features_partitioned(
    model,
    image_loader,  # callable(index) -> [H, W, 3] float32 normalized image
    num_images: int,
    num_partitions: int = 100,
    batch_size: int = 256,
    save_dir: Optional[str] = None,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extraction in bounded-memory partitions, each saved to
    `<save_dir>/features_part<p>.npz` and read back instead of recomputed
    when that file exists (resume). Returns ([N, 512] embeddings, [N, 1]
    norms)."""
    part_size = math.ceil(num_images / num_partitions)
    all_emb, all_norm = [], []
    for p in range(num_partitions):
        lo = p * part_size
        hi = min(lo + part_size, num_images)
        if lo >= hi:
            break
        part_file = os.path.join(save_dir, f"features_part{p}.npz") if save_dir else None
        if part_file and os.path.exists(part_file):
            z = np.load(part_file)
            all_emb.append(z["emb"])
            all_norm.append(z["norm"])
            continue
        images = np.stack([image_loader(i) for i in range(lo, hi)])
        emb, norm = extract_embeddings_tta(model, images, batch_size, mesh=mesh, device=device)
        if part_file:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(part_file, emb=emb, norm=norm)
        all_emb.append(emb)
        all_norm.append(norm)
    return np.concatenate(all_emb), np.concatenate(all_norm)


def validate_5sets(model, data_dir: str, batch_size: int = 256, device=None) -> Dict[str, Dict[str, float]]:
    """Flip-TTA 10-fold accuracy on each of the five validation sets found
    under `data_dir`, and their mean (`val_acc`). Raises FileNotFoundError
    when none is there."""
    from jabd_tpu_torch.recognition.data import load_five_validation_sets

    out: Dict[str, Dict[str, float]] = {}
    accs = []
    for name, (data, issame) in load_five_validation_sets(data_dir).items():
        res = validate_verification(model, np.asarray(data), np.asarray(issame), batch_size, device=device)
        out[name] = res
        accs.append(res["val_acc"])
    if not accs:
        raise FileNotFoundError(
            f"no validation sets found under {data_dir!r} "
            "(expected agedb_30/cfp_fp/lfw/cplfw/calfw memfiles or bins)"
        )
    out["mean"] = {"val_acc": float(np.mean(accs))}
    return out


def validate_verification(
    model,
    data: np.ndarray,  # [N, H, W, 3] uint8 or normalized float
    issame: np.ndarray,
    batch_size: int = 256,
    device=None,
) -> Dict[str, float]:
    """10-fold verification accuracy on one set (even rows against odd
    rows)."""
    if data.dtype == np.uint8:
        data = (data.astype(np.float32) / 255.0 - 0.5) / 0.5
    emb, _ = extract_embeddings_tta(model, data, batch_size, device=device)
    _, _, accuracy, best_thresholds = V.evaluate(emb, issame)
    return {
        "val_acc": float(accuracy.mean()),
        "val_acc_std": float(accuracy.std()),
        "best_threshold": float(best_thresholds.mean()),
    }
