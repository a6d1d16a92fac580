"""The detector graph and `build_model`. Port of `RetinaFace`
(jabd_tpu/models/retinaface.py) for every preset of `configs.py`.

  backbone taps -> [tap dropout, train mode] -> [tap ECA] -> FPN (upsample
  [+ NLM]) -> [shared eca_fpn] -> SSH -> per-level 1x1 heads ->
  (bbox [B,P,4], cls [B,P,2], landm [B,P,10] [, iou [B,P,1]]) in float32,
  softmax on cls in eval mode.

Input is NCHW; head rows are in the JAX package's NHWC flatten order.
The graph computes in the dtype of its parameters: float32 as built, or
bfloat16 once the caller casts the module (`Predictor` does so for
`compute_dtype="bfloat16"`, after folding the BatchNorms). Training keeps
float32 parameters and runs the forward under torch.autocast instead
(`train.make_train_step`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.configs import ModelConfig
from jabd_tpu_torch.models import layers as L
from jabd_tpu_torch.models.epsa import EPSANetBackbone
from jabd_tpu_torch.models.mobilenet import (
    MNV3_LARGE_3STAGE,
    MNV3_LARGE_4STAGE,
    MobileNetV1Backbone,
    MobileNetV3Backbone,
)
from jabd_tpu_torch.models.resnet import RESNET_SPECS, build_resnet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _eca_kind(kind: str) -> str:
    return "stdv" if kind == "eca_stdv" else "avg"


def _make_backbone(cfg: ModelConfig) -> nn.Module:
    if cfg.backbone == "mobilenet_v1_025":
        return MobileNetV1Backbone()
    if cfg.backbone == "mobilenet_v3_large":
        stages = MNV3_LARGE_4STAGE if cfg.num_levels == 4 else MNV3_LARGE_3STAGE
        return MobileNetV3Backbone(stages, block_attention=cfg.backbone_block_attention)
    if cfg.backbone == "epsanet50":
        return EPSANetBackbone()
    # The 4-level ResNet-152 taps layer1..4.
    name = "resnet152_l4" if cfg.backbone == "resnet152" and cfg.num_levels == 4 else cfg.backbone
    if name in RESNET_SPECS:
        return build_resnet(name)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


def dropout_keep(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The keep mask of dropout at rate p: each element kept with
    probability 1 - p, drawn from `generator` (torch's default stream when
    None)."""
    return torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p


def tap_dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Train-mode dropout: x / (1 - p) where `dropout_keep`, else 0."""
    return torch.where(dropout_keep(x, p, generator), x / (1.0 - p), 0.0)


class RetinaFace(nn.Module):
    """mode 'train' returns raw class logits; 'eval' their softmax."""

    def __init__(self, cfg: ModelConfig, mode: str = "train"):
        super().__init__()
        self.cfg = cfg
        self.mode = mode
        self.backbone = _make_backbone(cfg)
        if cfg.tap_attention:
            for i, c in enumerate(cfg.in_channels):
                self.add_module(
                    f"eca_tap{i + 1}",
                    L.ECA(c, _eca_kind(cfg.tap_attention), cfg.eca_gate),
                )
        self.fpn = L.FPN(
            cfg.in_channels,
            cfg.out_channels,
            upsample=cfg.fpn_upsample,
            nlm_ch=cfg.nlm.ch if cfg.nlm else None,
            nlm_psp=cfg.nlm.psp_sizes if cfg.nlm else (1, 3, 6, 8),
            variant=cfg.fpn_variant,
        )
        # ONE eca_fpn shared by all levels, as in the reference.
        self.eca_fpn = (
            L.ECA(cfg.out_channels, _eca_kind(cfg.fpn_attention), cfg.eca_gate)
            if cfg.fpn_attention
            else None
        )
        a, c = cfg.anchors_per_cell, cfg.out_channels
        self.head_names = ("bbox_head", "class_head", "landmark_head") + (
            ("iou_head",) if cfg.with_iou_head else ()
        )
        # ssh_share_level4: level 4 runs ssh3; there is no ssh4.
        self.ssh_names = [
            f"ssh{3 if cfg.ssh_share_level4 and i == 3 else i + 1}" for i in range(cfg.num_levels)
        ]
        for i in range(cfg.num_levels):
            if self.ssh_names[i] == f"ssh{i + 1}":
                self.add_module(f"ssh{i + 1}", L.SSH(c, c))
            for name, dim in zip(self.head_names, (4, 2, 10, 1)):
                self.add_module(f"{name}{i + 1}", L.PredictionHead(c, dim, a))

    def forward(
        self,
        images: torch.Tensor,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """remat (training) checkpoints the graph in segments, each
        recomputed in backward on its own: the stem and every backbone
        block, the FPN, each level's SSH. `generator` draws the tap
        dropout's masks in train mode (`step.dropout_seed`)."""
        cfg = self.cfg
        # The heads' dtype is the model's: they stay floating point when
        # int8 quantization (models/quantize.py) replaces a ConvBN's conv.
        x = images.to(self.bbox_head1.conv1x1.weight.dtype)
        taps = self.backbone(x, remat)[: cfg.num_levels]
        if cfg.tap_dropout > 0.0 and self.training:
            taps = [tap_dropout(t, cfg.tap_dropout, generator) for t in taps]
        if cfg.tap_attention:
            taps = [getattr(self, f"eca_tap{i + 1}")(t) for i, t in enumerate(taps)]
        feats = L.segment(self.fpn, taps, remat)
        if self.eca_fpn is not None:
            feats = [self.eca_fpn(f) for f in feats]
        feats = [L.segment(getattr(self, name), f, remat) for name, f in zip(self.ssh_names, feats)]

        def heads(name):
            return torch.cat(
                [getattr(self, f"{name}{i + 1}")(f) for i, f in enumerate(feats)],
                dim=1,
            ).float()

        out = [heads(name) for name in self.head_names]
        if self.mode == "eval":
            out[1] = torch.softmax(out[1], dim=-1)
        return tuple(out)


def build_model(cfg: ModelConfig, mode: str = "train", device=None) -> RetinaFace:
    """The detector for `cfg` with float32 parameters on `device` (the
    card unless given; raises without one). Raises ValueError where the
    JAX package does: `eca_g` block attention with 4 levels."""
    if cfg.backbone == "mobilenet_v3_large" and cfg.num_levels == 4 and cfg.backbone_block_attention == "eca_g":
        # The eca_g block indices encode the 3-stage split; under the
        # 4-stage split they would land on other blocks.
        raise ValueError(
            "backbone_block_attention='eca_g' is defined for the "
            "3-level MobileNetV3 split only (no 4-level ecaG variant "
            "exists in the reference)"
        )
    return RetinaFace(cfg, mode).to(resolve_device(device))
