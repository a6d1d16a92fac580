"""The detector graph and `build_model`. Port of `RetinaFace`
(jabd_tpu/models/retinaface.py) for the configurations this port covers.

  backbone taps -> [tap ECA] -> FPN (upsample [+ NLM]) -> [shared eca_fpn]
  -> SSH -> per-level 1x1 heads -> (bbox [B,P,4], cls [B,P,2],
  landm [B,P,10]) in float32, softmax on cls in eval mode.

Input is NCHW; head rows are in the JAX package's NHWC flatten order.
The graph computes in the dtype of its parameters: float32 as built, or
bfloat16 once the caller casts the module (`Predictor` does so for
`compute_dtype="bfloat16"`, after folding the BatchNorms). Training keeps
float32 parameters and runs the forward under torch.autocast instead
(`train.make_train_step`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.configs import ModelConfig
from jabd_tpu_torch.models import layers as L
from jabd_tpu_torch.models.mobilenet import MNV3_LARGE_3STAGE, MobileNetV1Backbone, MobileNetV3Backbone

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


BACKBONES = ("mobilenet_v3_large", "mobilenet_v1_025")


def _eca_kind(kind: str) -> str:
    return "stdv" if kind == "eca_stdv" else "avg"


def _make_backbone(cfg: ModelConfig) -> nn.Module:
    if cfg.backbone == "mobilenet_v1_025":
        return MobileNetV1Backbone()
    return MobileNetV3Backbone(MNV3_LARGE_3STAGE, block_attention=cfg.backbone_block_attention)


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
        )
        # ONE eca_fpn shared by all levels, as in the reference.
        self.eca_fpn = (
            L.ECA(cfg.out_channels, _eca_kind(cfg.fpn_attention), cfg.eca_gate)
            if cfg.fpn_attention
            else None
        )
        a, c = cfg.anchors_per_cell, cfg.out_channels
        for i in range(cfg.num_levels):
            self.add_module(f"ssh{i + 1}", L.SSH(c, c))
            self.add_module(f"bbox_head{i + 1}", L.PredictionHead(c, 4, a))
            self.add_module(f"class_head{i + 1}", L.PredictionHead(c, 2, a))
            self.add_module(f"landmark_head{i + 1}", L.PredictionHead(c, 10, a))

    def forward(
        self, images: torch.Tensor, remat: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """remat (training) checkpoints the graph in segments, each
        recomputed in backward on its own: the stem and every backbone
        block, the FPN, each level's SSH."""
        cfg = self.cfg
        x = images.to(self.backbone.stem.conv.weight.dtype)
        taps = self.backbone(x, remat)[: cfg.num_levels]
        if cfg.tap_attention:
            taps = [getattr(self, f"eca_tap{i + 1}")(t) for i, t in enumerate(taps)]
        feats = L.segment(self.fpn, taps, remat)
        if self.eca_fpn is not None:
            feats = [self.eca_fpn(f) for f in feats]
        feats = [L.segment(getattr(self, f"ssh{i + 1}"), f, remat) for i, f in enumerate(feats)]

        def heads(name):
            return torch.cat(
                [getattr(self, f"{name}{i + 1}")(f) for i, f in enumerate(feats)],
                dim=1,
            ).float()

        bbox, cls, landm = heads("bbox_head"), heads("class_head"), heads("landmark_head")
        if self.mode == "eval":
            cls = torch.softmax(cls, dim=-1)
        return bbox, cls, landm


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration this port does not
    build yet; it never substitutes another model."""
    unported = []
    if cfg.backbone not in BACKBONES:
        unported.append(f"backbone {cfg.backbone!r}")
    if cfg.num_levels != 3:
        unported.append(f"{cfg.num_levels}-level pyramid")
    if cfg.fpn_variant != "cascade":
        unported.append(f"FPN variant {cfg.fpn_variant!r}")
    if cfg.fpn_upsample not in ("nearest", "bilinear", "bicubic"):
        unported.append(f"FPN upsample {cfg.fpn_upsample!r}")
    if cfg.with_iou_head:
        unported.append("IoU head")
    if cfg.tap_dropout:
        unported.append("tap dropout")
    if unported:
        raise NotImplementedError(
            f"model {cfg.name!r} needs what the PyTorch port does not have "
            f"yet: {', '.join(unported)}"
        )


def build_model(cfg: ModelConfig, mode: str = "train", device=None) -> RetinaFace:
    """The detector for `cfg` with float32 parameters on `device` (the
    card unless given; raises without one)."""
    check_supported(cfg)
    return RetinaFace(cfg, mode).to(resolve_device(device))
