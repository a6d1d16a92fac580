"""Training: optimizer, schedule, train step and the two-phase fit loop.

Port of `jabd_tpu/train.py`. The reference's recipe
(train_mobilenetV3_ecagai.py:436-615, utils/utils_fit_change.py:11-64):

  * two phases, "freeze" (lr 1e-3, backbone frozen, epochs 0..freeze) and
    "unfreeze" (lr 1e-4), each with a FRESH Adam(weight_decay=5e-4) and
    StepLR(gamma=0.92) per epoch;
  * MultiBoxLoss(2, 0.35, 7), total = 2.0 * loc + conf + landm;
  * a checkpoint every save_period epochs.

torch's Adam(weight_decay) adds the L2 term to the gradient before the
moments, which is what the JAX package's optax.add_decayed_weights before
scale_by_adam computes. A frozen backbone has requires_grad False: it gets
no gradient, so Adam neither updates nor decays it (optax.set_to_zero),
while its BatchNorm statistics still update in the train-mode forward.

The step runs eagerly and updates the state in place (model parameters,
BatchNorm buffers, Adam moments); it returns the state as the JAX step
returns its new one. With `compute_dtype="bfloat16"` the forward runs
under torch.autocast: parameters and Adam stay float32, convolutions and
matmuls run in bfloat16, the heads are cast to float32 and the loss is
float32, as flax computes with dtype=bfloat16 over float32 parameters.

Over a process mesh (`mesh=`, parallel/mesh.py: one process per card) the
step is the JAX package's mesh step: each rank runs its rows of the global
batch, its BatchNorms are synchronized over the mesh (models/layers.py::
convert_sync_batchnorm), the loss is normalized by the global positive
counts and matches each rank's rows (K2 on the card), and the gradients
are summed over the mesh in one bucket before the same Adam update on
every rank. With `fsdp` the parameters the JAX leaf rule shards, and
their Adam moments, are sharded by FSDP2 (parallel/fsdp.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from jabd_tpu_torch import configs, losses, resolve_device
from jabd_tpu_torch import step as ST
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.init import reference_weights_init
from jabd_tpu_torch.ops import anchors as A
from jabd_tpu_torch.parallel import fsdp as FS
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.utils import tracing as T


def check_supported(model_cfg: configs.ModelConfig, train_cfg: configs.TrainConfig) -> None:
    """Raise ValueError for a model the loss cannot take; it never runs
    something else in its place."""
    if model_cfg.with_iou_head:
        raise ValueError(
            f"model {model_cfg.name!r} has an IoU head (a fourth output); the "
            "multibox loss takes (loc, conf, landm) only, as in the JAX package"
        )


def step_lr(lr: float, steps_per_epoch: int, gamma: float, count: int) -> float:
    """StepLR once per epoch, per update: update `count` (from 0) uses
    lr * gamma ** floor(count / steps_per_epoch), as
    optax.exponential_decay(staircase=True) does."""
    return lr * gamma ** (count // max(steps_per_epoch, 1))


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 5e-4):
    """torch Adam with L2 weight decay into the gradient."""
    params = list(params)
    return torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        foreach=FS.foreach_flag(params),
    )


def freeze_backbone(model: torch.nn.Module, freeze: bool) -> None:
    """requires_grad False on the backbone (train script :576-578), or
    True again."""
    for p in model.backbone.parameters():
        p.requires_grad_(not freeze)


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and schedule of one training phase.

    `step` counts every update since the start; `count` the updates of
    this phase's optimizer, which the schedule reads (the JAX package's
    ScaleByScheduleState count). Under FSDP `state_dict` gathers the full
    state in the single-process layout (a collective: every rank calls
    it) and `load_state_dict` takes that layout."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr: float
    steps_per_epoch: int
    gamma: float
    step: int = 0
    count: int = 0
    mesh: Optional[M.Mesh] = None

    def lr_at(self, count: int) -> float:
        return step_lr(self.lr, self.steps_per_epoch, self.gamma, count)

    def apply_gradients(self) -> None:
        """One Adam update with the gradients in `.grad`, at the lr of
        the schedule's current count."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.optimizer.step()
        self.count += 1
        self.step += 1

    def state_dict(self) -> Dict:
        return {
            "model": FS.full_model_state_dict(self.model),
            "optimizer": FS.full_optimizer_state_dict(self.optimizer),
            "step": self.step,
            "count": self.count,
        }

    def load_state_dict(self, payload: Dict) -> None:
        FS.load_full_model_state_dict(self.model, payload["model"])
        FS.load_full_optimizer_state_dict(self.optimizer, payload["optimizer"])
        self.step = int(payload["step"])
        self.count = int(payload["count"])


def new_phase(state: TrainState, lr: float, freeze: bool, weight_decay: float) -> TrainState:
    """Start a phase: (un)freeze the backbone and give the state a fresh
    optimizer at `lr` with its schedule count at 0 (reference :564,596)."""
    freeze_backbone(state.model, freeze)
    state.optimizer = make_optimizer(state.model.parameters(), lr, weight_decay)
    state.lr = lr
    state.count = 0
    return state


def create_train_state(
    model_cfg: configs.ModelConfig,
    train_cfg: configs.TrainConfig,
    steps_per_epoch: int,
    lr: Optional[float] = None,
    freeze_backbone: bool = False,
    device=None,
    mesh: Optional[M.Mesh] = None,
) -> TrainState:
    """A train-mode model with the reference's from-scratch init (drawn on
    the CPU from a torch.Generator seeded with train_cfg.seed), moved to
    `device` (the card unless given), and a fresh optimizer. Over a process
    mesh of size > 1 (`place_on_mesh`) the BatchNorms are synchronized,
    rank 0's weights broadcast and, with `fsdp`, the model sharded."""
    dev = resolve_device(device)
    model = build_model(model_cfg, mode="train", device="cpu")
    reference_weights_init(
        model, torch.Generator().manual_seed(train_cfg.seed), train_cfg.weights_init
    )
    model.to(dev)
    place_on_mesh(model, mesh, train_cfg.fsdp)
    state = TrainState(
        model=model,
        optimizer=None,
        lr=0.0,
        steps_per_epoch=steps_per_epoch,
        gamma=train_cfg.lr_gamma,
        mesh=mesh,
    )
    return new_phase(state, lr or train_cfg.lr_freeze, freeze_backbone, train_cfg.weight_decay)


def place_on_mesh(model: torch.nn.Module, mesh: Optional[M.Mesh], fsdp: bool = False) -> torch.nn.Module:
    """Make `model` a replica of a process mesh of size > 1, in place:
    synchronized BatchNorms, rank 0's parameters and statistics everywhere
    (`replicate_tree`), and FSDP2 under the leaf rule with `fsdp`. Build
    the optimizer after it. A smaller mesh, or None, leaves the model as
    it is (the JAX package's fit replicates, or FSDP-shards, only when
    mesh.size > 1)."""
    if not M.is_sharded(mesh):
        return model
    from jabd_tpu_torch.models.layers import convert_sync_batchnorm

    convert_sync_batchnorm(model, mesh)
    M.replicate_tree(model, mesh)
    if fsdp:
        FS.shard_model(model, mesh)
    return model


def _batchnorm_stats(model: torch.nn.Module):
    """Every tracking BatchNorm with copies of its running statistics."""
    return [
        (m, m.running_mean.clone(), m.running_var.clone(), m.num_batches_tracked.clone())
        for m in model.modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.track_running_stats
    ]


def _restore_batchnorm_stats(saved) -> None:
    for m, mean, var, count in saved:
        m.running_mean, m.running_var, m.num_batches_tracked = mean, var, count


def make_train_step(model_cfg: configs.ModelConfig, train_cfg: configs.TrainConfig, mesh: Optional[M.Mesh] = None):
    """step(state, images [B, H, W, 3] float32, targets, anchors [P, 4])
    -> (state, metrics): train-mode forward -> multibox_loss ->
    total_loss -> backward -> Adam update (`step.run_step`). Images,
    targets and anchors lie on the model's device. Metrics are 0-d device
    tensors: loss, loss_l, loss_c, loss_landm.

    With `device_augment` the step is step(state, images_u8 [B, bh, bw, 3]
    uint8, plan, targets, anchors): `data/device_augment.device_augment`
    (bf16 resample, no gradient) makes each chunk's frames on the device
    first.

    `remat` runs the forward in checkpointed segments (`RetinaFace.forward`:
    each backbone block, the FPN, each SSH; non-reentrant
    torch.utils.checkpoint under the same autocast): backward recomputes
    one segment at a time instead of keeping every activation, so only the
    segments' inputs live across the step. The JAX package wraps the whole
    forward in one jax.checkpoint; one checkpoint in torch would rebuild
    every activation before the backward walks them, and save no memory.
    The recompute runs the train-mode forward again, which would update
    the BatchNorm running statistics a second time; the step keeps the
    statistics of the first forward (copied after it, put back when the
    chunk's metrics are taken, right after backward), as jax.checkpoint
    updates them once.

    `microbatches` > 1 (ghost BatchNorm, jabd_tpu/train.py:201-258): each
    chunk has its own forward, loss (normalized by its own positives) and
    backward. `tap_dropout` draws from the step's dropout stream under
    `train_cfg.seed`.

    `mesh`: the process mesh the batch is sharded over (fit's). Images,
    plan and targets are then this rank's rows, chunk i of them its shard
    of the global chunk i (`parallel.mesh.shard_batch(..., chunks=
    microbatches)`); the model is a replica made by `place_on_mesh`
    (`create_train_state(mesh=)`), its BatchNorms synchronized. Each rank's
    loss terms are its share of the global terms (losses.multibox_loss
    `matching_mesh`), so the summed metrics are the global batch's. A mesh
    of size 1 is the plain step.

    Each step opens a `jabd.train.step` span (`step.run_step`; the loss
    phase `jabd.train.loss`).

    Raises ValueError for a model with an IoU head."""
    check_supported(model_cfg, train_cfg)
    mesh = mesh if M.is_sharded(mesh) else None

    def run(state: TrainState, make_images, batch: int, targets: losses.Targets, anchors: torch.Tensor):
        model = state.model
        model.train()
        saved = []

        def forward(x, generator):
            out = model(x, remat=train_cfg.remat, generator=generator)
            if train_cfg.remat:
                saved[:] = _batchnorm_stats(model)
            return out

        def metrics(total, parts):
            _restore_batchnorm_stats(saved)
            return {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}}

        def loss(out, part):
            parts = losses.multibox_loss(
                out,
                anchors,
                losses.Targets(*(t[part] for t in targets)),
                overlap_threshold=train_cfg.overlap_threshold,
                neg_pos_ratio=train_cfg.neg_pos_ratio,
                variances=model_cfg.anchors.variance,
                box_loss=model_cfg.box_loss,
                matching_impl=train_cfg.matching_impl,
                matching_mesh=mesh,
            )
            total = losses.total_loss(parts, train_cfg.loc_weight)
            return total, lambda: metrics(total, parts)

        return state, ST.run_step(
            state, make_images, batch, forward, loss, prefix="jabd.train", microbatches=train_cfg.microbatches,
            mesh=mesh, bf16=model_cfg.compute_dtype == "bfloat16", seed=train_cfg.seed,
            dropout=model_cfg.tap_dropout > 0.0, metric_shares=True,
        )

    if not train_cfg.device_augment:

        def step(state: TrainState, images: torch.Tensor, targets: losses.Targets, anchors: torch.Tensor):
            return run(state, lambda part: images[part], images.shape[0], targets, anchors)

        return step

    from jabd_tpu_torch.data.device_augment import device_augment

    def aug_step(state: TrainState, images_u8: torch.Tensor, plan, targets: losses.Targets, anchors: torch.Tensor):
        def make_images(part):
            with torch.no_grad(), T.span("jabd.train.augment"):
                return device_augment(images_u8[part], type(plan)(*(t[part] for t in plan)))

        return run(state, make_images, images_u8.shape[0], targets, anchors)

    return aug_step


def fit(
    model_cfg: configs.ModelConfig,
    train_cfg: configs.TrainConfig,
    dataset,
    log_dir: str = "logs",
    checkpoint_manager=None,
    start_epoch: int = 0,
    init_state: Optional[TrainState] = None,
    device=None,
    mesh: Optional[M.Mesh] = None,
) -> TrainState:
    """The two-phase loop (freeze -> unfreeze) of
    train_mobilenetV3_ecagai.py:553-615 on `device` (the card unless
    given). Batches come from `data/wider.train_loader` (host augmentation)
    or, with `device_augment`, `data/device_augment.device_train_loader`
    (uint8 sources and plans at `augment_bucket`), through
    `step.prefetch_to_device`. Appends one row per epoch to
    `<log_dir>/metrics.csv`, resumes from the latest checkpoint of
    `checkpoint_manager` (optimizer included) and always saves the final
    state. Returns the TrainState.

    `mesh` defaults to the initialized process group's (`parallel.mesh.
    process_mesh`; size 1 without one). Over a mesh of size > 1 every rank
    loads the same global batches and keeps its rows, the step is the mesh
    step (`make_train_step(mesh=)`, FSDP with `fsdp`), and only rank 0
    logs, writes metrics.csv and writes checkpoints, in the single-process
    layout (`partial_load` and utils/convert.py read them as they are);
    every rank resumes from them. Raises ValueError when the batch (each
    microbatch chunk) does not divide the mesh."""
    from jabd_tpu_torch.data.device_augment import device_train_loader
    from jabd_tpu_torch.data.wider import train_loader
    from jabd_tpu_torch.utils.logging import LossHistory

    dev = resolve_device(device)
    mesh = mesh or M.process_mesh(dev)
    mb = max(train_cfg.microbatches, 1)
    M.check_divisible(train_cfg.batch_size, mesh, mb)
    lead = mesh.rank == 0
    step_fn = make_train_step(model_cfg, train_cfg, mesh=mesh)
    steps_per_epoch = max(len(dataset) // train_cfg.batch_size, 1)
    size = (train_cfg.image_size, train_cfg.image_size)
    anchors = torch.from_numpy(A.generate_anchors(model_cfg.anchors, size).copy()).to(dev)
    metrics_path = os.path.join(log_dir, "metrics.csv")
    if lead:
        history = LossHistory(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        if not os.path.exists(metrics_path):
            with open(metrics_path, "w") as f:
                f.write("epoch,step,loss,loss_l,loss_c,loss_landm,lr\n")

    state = init_state
    resume_phase_freeze = None
    just_resumed = False
    if (
        state is None
        and checkpoint_manager is not None
        and checkpoint_manager.latest_step() is not None
    ):
        resumed_epoch = checkpoint_manager.latest_step()
        # The checkpoint of step s was written by epoch s - 1, so it
        # belongs to the freeze phase iff s - 1 < freeze_epochs (also the
        # one saved exactly at the boundary).
        resume_phase_freeze = (resumed_epoch - 1) < train_cfg.freeze_epochs
        template = create_train_state(
            model_cfg,
            train_cfg,
            steps_per_epoch,
            lr=train_cfg.lr_freeze if resume_phase_freeze else train_cfg.lr_unfreeze,
            freeze_backbone=resume_phase_freeze,
            device=dev,
            mesh=mesh,
        )
        state = checkpoint_manager.restore(template)
        start_epoch = max(start_epoch, resumed_epoch)
        just_resumed = True
        if lead:
            print(f"resumed from checkpoint at epoch {resumed_epoch}")

    phase_bounds = [
        (start_epoch, train_cfg.freeze_epochs, train_cfg.lr_freeze, True),
        (
            max(train_cfg.freeze_epochs, start_epoch),
            train_cfg.total_epochs,
            train_cfg.lr_unfreeze,
            False,
        ),
    ]
    for first, last, lr, freeze in phase_bounds:
        if first >= last:
            if just_resumed and freeze == resume_phase_freeze:
                # The restored phase is complete (a boundary resume): the
                # next phase builds its optimizer fresh.
                just_resumed = False
            continue
        if state is None:
            state = create_train_state(
                model_cfg, train_cfg, steps_per_epoch, lr=lr,
                freeze_backbone=freeze, device=dev, mesh=mesh,
            )
        elif just_resumed:
            just_resumed = False  # mid-phase resume keeps the restored optimizer
        else:
            new_phase(state, lr, freeze, train_cfg.weight_decay)

        for epoch in range(first, last):
            t0 = time.time()
            cur_lr = state.lr_at(state.count)  # the epoch's first update
            step_metrics = []  # device tensors: one host sync per epoch
            seed = train_cfg.seed + epoch
            if train_cfg.device_augment:
                batches = (
                    (torch.from_numpy(images_u8), plan, *map(torch.from_numpy, arrays))
                    for images_u8, plan, arrays in device_train_loader(
                        dataset, train_cfg.batch_size, bucket_hw=train_cfg.augment_bucket,
                        max_targets=train_cfg.max_targets, seed=seed,
                    )
                )
            else:
                batches = (
                    (torch.from_numpy(images.astype(np.float32, copy=False)), None,
                     *map(torch.from_numpy, arrays))
                    for images, arrays in train_loader(
                        dataset, train_cfg.batch_size, max_targets=train_cfg.max_targets, seed=seed,
                    )
                )
            for images, plan, *arrays in ST.prefetch_to_device(batches, dev, 2, mesh=mesh, chunks=mb):
                targets = losses.Targets(*arrays)
                if plan is None:
                    state, metrics = step_fn(state, images, targets, anchors)
                else:
                    state, metrics = step_fn(state, images, plan, targets, anchors)
                step_metrics.append(metrics)
            nsteps = len(step_metrics)
            means = {
                k: float(torch.stack([m[k] for m in step_metrics]).mean()) if nsteps else 0.0
                for k in ("loss", "loss_l", "loss_c", "loss_landm")
            }
            if lead:
                history.append_loss(means["loss"])
                with open(metrics_path, "a") as f:
                    f.write(
                        f"{epoch + 1},{state.step},{means['loss']:.6f},"
                        f"{means['loss_l']:.6f},{means['loss_c']:.6f},"
                        f"{means['loss_landm']:.6f},{cur_lr:.8f}\n"
                    )
                print(
                    f"epoch {epoch + 1}/{last} loss={means['loss']:.4f} lr={cur_lr:.6f} "
                    f"({time.time() - t0:.1f}s, {nsteps} steps)"
                )
            if checkpoint_manager is not None and (epoch + 1) % train_cfg.save_period == 0:
                ST.save_checkpoint(checkpoint_manager, epoch + 1, state, mesh)
    if (
        checkpoint_manager is not None
        and state is not None
        and checkpoint_manager.latest_step() != train_cfg.total_epochs
    ):
        ST.save_checkpoint(checkpoint_manager, train_cfg.total_epochs, state, mesh)
    return state

