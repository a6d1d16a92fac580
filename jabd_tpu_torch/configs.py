"""Configuration tree of the PyTorch port: its own copy of the JAX
package's `jabd_tpu/configs.py` (AnchorConfig, NLMConfig, ModelConfig,
TrainConfig, PredictConfig, the anchor presets, MODEL_PRESETS,
get_model_config).

Standard library only. The port keeps a copy instead of importing the JAX
package, so that it runs where JAX is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Anchor / geometry config (reference utils/config.py keys)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Mirrors the anchor-relevant keys of the reference cfg dicts.

    Reference: utils/config.py:1-152 (`min_sizes`, `steps`, `variance`,
    `clip`, `train_image_size`).
    """

    min_sizes: Tuple[Tuple[int, ...], ...]
    steps: Tuple[int, ...]
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = False
    train_image_size: int = 840

    @property
    def num_levels(self) -> int:
        return len(self.steps)


# ---------------------------------------------------------------------------
# Model config — the ablation grid as switches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NLMConfig:
    """Cross-scale non-local module (CSAF) geometry.

    Reference: `nets/retinaface_eca_nonlocal.py:155-200` (ch=4,
    psp=(1,4,8,12)); flagship `train_mobilenetV3_ecagai.py:183-228` (ch=40,
    psp=(1,3,6,8)).
    """

    ch: int = 40
    psp_sizes: Tuple[int, ...] = (1, 3, 6, 8)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One detector graph covering the reference's variant grid."""

    name: str = "jabd_flagship"
    anchors: AnchorConfig = dataclasses.field(
        default_factory=lambda: CFG_MNET
    )
    # Backbone: 'mobilenet_v1_025' | 'mobilenet_v3_large' | 'resnet50' |
    # 'resnet101' | 'resnet152' | 'epsanet50'
    backbone: str = "mobilenet_v3_large"
    # Attention inside backbone bottlenecks (MobileNetV3 only):
    # None | 'eca' (Block_eca) | 'eca_g' (Block_eca_G mix of ecagai train)
    backbone_block_attention: Optional[str] = "eca"
    # Number of pyramid taps from the backbone (3 or 4/5-level variants).
    num_levels: int = 3
    # Channel counts of the tapped feature maps (cfg in_channel * 2/4/8).
    in_channels: Tuple[int, ...] = (40, 80, 160)
    # FPN/SSH/head channel count (cfg out_channel).
    out_channels: int = 40
    # External ECA on backbone taps before the FPN (eca_40/80/160 in the
    # flagship, eca_512/1024/2048 in retinaface_eca_nonlocal.py:280-282).
    tap_attention: Optional[str] = "eca_stdv"  # None|'eca'|'eca_stdv'
    # ECA applied to each FPN output before SSH (eca_fpn).
    fpn_attention: Optional[str] = "eca_stdv"
    # ECA gate for the *external* eca blocks: 'sigmoid' (eca_nonlocal.py:217)
    # or 'hsigmoid' (flagship :314, mobilenetV3.py:346).
    eca_gate: str = "hsigmoid"
    # FPN top-down upsample: 'nearest' | 'bicubic' (align_corners=True,
    # train_mobilenetV3_ecagai.py:270,279) | 'bilinear'
    fpn_upsample: str = "bicubic"
    # FPN wiring: 'cascade' (3-level reference) | 'raw152' (FPN_152) |
    # 'raw152_5' (FPN_152_5) — see models/layers.py FPN docstring.
    fpn_variant: str = "cascade"
    # Non-local module on the upsampled top-down maps; None disables.
    nlm: Optional[NLMConfig] = dataclasses.field(default_factory=NLMConfig)
    # Anchors per level-cell (every reference config uses 2).
    anchors_per_cell: int = 2
    # Optional IoU-prediction head (nets/retinaface_IOU.py /
    # IOUHead nets/retinaface_eca_nonlocal.py:123-132 — defined there but
    # dead in forward; functional here when enabled).
    with_iou_head: bool = False
    # Dropout on the backbone taps BEFORE the tap ECAs, reproducing
    # nets/retinaface_eca_nonlocal_droupout.py:322-325 (`F.dropout` on the
    # three body outputs, p=0.5). Reference quirk: functional `F.dropout`
    # defaults to training=True, so the reference drops (and rescales) at
    # EVAL too — we deliberately deviate and make eval deterministic
    # (standard dropout semantics); train mode matches. See PARITY.md.
    tap_dropout: float = 0.0
    # 4-level reference assemblies apply ssh3 to BOTH levels 3 and 4
    # (retinaface_152.py:154 / retinaface50_self.py:152: `feature4 =
    # self.ssh3(fpn[3])`; their ssh4/ssh5 are built but dead). True
    # shares the level-3 SSH module with level 4 for weight parity.
    ssh_share_level4: bool = False
    # Leaky-relu slope rule: leaky=0.1 iff out_channels <= 64
    # (nets/layers.py:41-43, 73-75).
    # Loss: 'smooth_l1' (retinaface_training.py) | 'diou'
    # (retinaface_training_DIOU.py)
    box_loss: str = "smooth_l1"
    # Compute dtype for the conv stack ('bfloat16' for TPU MXU, 'float32').
    compute_dtype: str = "bfloat16"

    @property
    def leaky_slope(self) -> float:
        return 0.1 if self.out_channels <= 64 else 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters.

    Reference: two-phase loop in `train_mobilenetV3_ecagai.py:553-615`
    (Adam lr 1e-3 freeze / 1e-4 unfreeze, weight decay 5e-4, StepLR
    gamma 0.92/epoch), MultiBoxLoss(2, 0.35, 7) at :475, loc_weight 2.0.
    Every field and default of the JAX package's TrainConfig. The port's
    `train.py` runs `remat`, `microbatches > 1`, `device_augment` and,
    over a process group of more than one rank, `fsdp` (parallel/fsdp.py),
    alone or combined; on one process `fsdp` is the plain path, as in the
    JAX package's fit.
    """

    batch_size: int = 34
    image_size: int = 840
    freeze_epochs: int = 50
    total_epochs: int = 100
    lr_freeze: float = 1e-3
    lr_unfreeze: float = 1e-4
    lr_gamma: float = 0.92
    weight_decay: float = 5e-4
    overlap_threshold: float = 0.35
    neg_pos_ratio: int = 7
    loc_weight: float = 2.0
    num_classes: int = 2
    max_targets: int = 128  # padded GT boxes per image
    save_period: int = 5
    seed: int = 0
    # Recompute the forward pass in backward (activation memory for FLOPs).
    remat: bool = False
    # Microbatches per step (ghost BatchNorm, averaged gradients).
    microbatches: int = 1
    # Augmentation on the device instead of the host.
    device_augment: bool = False
    # Static uint8 source bucket (H, W) for device augmentation.
    augment_bucket: Tuple[int, int] = (1024, 1024)
    # From-scratch init of the reference (weights_init(net, 'normal',
    # 0.02), retinaface_training.py:305-324): 'normal' | 'xavier' |
    # 'kaiming' | 'orthogonal', or 'none' for torch's module defaults.
    weights_init: str = "normal"
    # Anchor matching inside the loss: 'auto' (the CUDA kernel on a CUDA
    # tensor, the plain version on a CPU tensor), 'cuda' (the kernel;
    # raises on a CPU tensor) or 'plain' (the dense torch version).
    matching_impl: str = "auto"
    # Parameters and Adam moments sharded over the data mesh.
    fsdp: bool = False


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Inference defaults. Reference: predict.py:25-60 `_defaults`."""

    confidence: float = 0.5
    # 0.3, NOT the 0.45 the reference's _defaults dict declares: every
    # reference call site passes only the confidence
    # (predict.py:181,303,329,399), so its "nms_iou" key is DEAD and the
    # EFFECTIVE threshold is non_max_suppression's default 0.3
    # (utils_bbox.py:260). Found by tests/test_pipeline_parity.py
    # (519 vs 181 keeps at 0.45); we default to the reference's
    # behavior, not its dead config.
    nms_iou: float = 0.3
    # 'iou' (torchvision parity) or 'diou' (utils/utils_bbox.py:182).
    nms_kind: str = "iou"
    input_shape: Tuple[int, int] = (1280, 1280)
    letterbox: bool = True
    max_detections: int = 750
    pre_nms_topk: int = 5000


# ---------------------------------------------------------------------------
# Anchor presets — value-for-value mirrors of utils/config.py
# ---------------------------------------------------------------------------

CFG_MNET = AnchorConfig(  # utils/config.py:1-19
    min_sizes=((16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 32),
)

CFG_MNET_4 = AnchorConfig(  # utils/config.py:20-41
    min_sizes=((4, 12), (16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 16, 32),
)

CFG_RE50 = AnchorConfig(  # utils/config.py:43-56
    min_sizes=((16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 32),
)

CFG_RE50_SELF = AnchorConfig(  # utils/config.py:57-81
    min_sizes=((8, 16), (32, 64), (64, 128), (256, 512)),
    steps=(8, 16, 32, 64),
)

CFG_RE152_3 = AnchorConfig(  # utils/config.py:82-93 (cfg_re152_)
    min_sizes=((16, 32), (64, 128), (256, 512)),
    steps=(8, 16, 32),
)

CFG_RE152 = AnchorConfig(  # utils/config.py:95-112
    min_sizes=((8, 16), (32, 64), (64, 128), (256, 512)),
    steps=(4, 8, 16, 32),
)

CFG_RE101 = AnchorConfig(  # utils/config.py:113-131
    min_sizes=((32, 64), (64, 128), (256, 512), (240, 480)),
    steps=(8, 16, 32, 60),
)

CFG_RE152_NEW = AnchorConfig(  # utils/config.py:132-152
    min_sizes=((8, 16), (32, 64), (64, 128), (256, 512)),
    steps=(4, 8, 16, 32),
)

ANCHOR_PRESETS: Dict[str, AnchorConfig] = {
    "mnet": CFG_MNET,
    "mnet_4": CFG_MNET_4,
    "re50": CFG_RE50,
    "re50_self": CFG_RE50_SELF,
    "re152_3": CFG_RE152_3,
    "re152": CFG_RE152,
    "re101": CFG_RE101,
    "re152_new": CFG_RE152_NEW,
}


# ---------------------------------------------------------------------------
# Model presets — the reference variant grid
# ---------------------------------------------------------------------------


def _mk(name: str, **kw) -> ModelConfig:
    return ModelConfig(name=name, **kw)


MODEL_PRESETS: Dict[str, ModelConfig] = {
    # Flagship JABD (train_mobilenetV3_ecagai.py inline RetinaFace :319-435):
    # MobileNetV3_Large_eca backbone, contrast-ECA taps 40/80/160 + eca_fpn,
    # NLM(ch=40, psp 1/3/6/8) on bicubic align_corners upsample.
    "jabd_flagship": _mk(
        "jabd_flagship",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca_stdv",
        fpn_attention="eca_stdv",
        eca_gate="hsigmoid",
        fpn_upsample="bicubic",
        nlm=NLMConfig(ch=40, psp_sizes=(1, 3, 6, 8)),
    ),
    # train_all_bicubic.py:231-271 sketches a pixelshuffle upsample
    # (pixelshuffle_block built but commented out of forward) — the last
    # unexplored axis of the ablation grid (SURVEY section 2.1 axis e).
    # Flagship assembly with the learned sub-pixel upsample + NLM ch=8
    # (that script's NLM width).
    "jabd_pixelshuffle": _mk(
        "jabd_pixelshuffle",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca_stdv",
        fpn_attention="eca_stdv",
        eca_gate="hsigmoid",
        fpn_upsample="pixelshuffle",
        nlm=NLMConfig(ch=8, psp_sizes=(1, 3, 6, 8)),
    ),
    # train_mobilenetV3_ecablockG.py: ecaG inside bottlenecks, NLM ch=4
    # psp (1,4,8,12), nearest upsample.
    "jabd_ecablock_g": _mk(
        "jabd_ecablock_g",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca_g",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca_stdv",
        fpn_attention="eca_stdv",
        eca_gate="hsigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
    ),
    # nets/retinaface_r.py — the IMPORTABLE module form of the JABD
    # assembly (train_movilenet.py:8 uses it, bs=24): MobileNetV3_Large_eca
    # backbone (in-block hsigmoid ECAs), avg-pool ECA taps eca_40/80/160 +
    # shared eca_fpn, all SIGMOID-gated (retinaface_r.py:219-222), nearest
    # FPN upsample with NLM(40) at its defaults ch=4 / psp (1,4,8,12)
    # (:156,167).
    "retinaface_r": _mk(
        "retinaface_r",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
    ),
    # train_mobilenet_r_eca.py: avg-pool ECA external taps.
    "jabd_eca_avg": _mk(
        "jabd_eca_avg",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="hsigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=40, psp_sizes=(1, 3, 6, 8)),
    ),
    # train_mobilenetV3_r.py: plain MobileNetV3 3-tap baseline.
    "mnet_v3_plain": _mk(
        "mnet_v3_plain",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention=None,
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # train_movilenet_4.py: 4-level MobileNetV3_Large_4 pyramid.
    "mnet_v3_4level": _mk(
        "mnet_v3_4level",
        anchors=CFG_MNET_4,
        backbone="mobilenet_v3_large",
        backbone_block_attention=None,
        num_levels=4,
        in_channels=(40, 80, 80, 160),
        out_channels=40,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface.py: vanilla RetinaFace with MobileNetV1-0.25.
    "retinaface_mnet025": _mk(
        "retinaface_mnet025",
        anchors=CFG_MNET,
        backbone="mobilenet_v1_025",
        backbone_block_attention=None,
        in_channels=(64, 128, 256),
        out_channels=64,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_eca_nonlocal.py (the predict.py model): resnet50
    # taps 512/1024/2048, avg ECA (sigmoid gate), NLM(ch=4, 1/4/8/12) on
    # nearest upsample, eca_fpn(256).
    "re50_eca_nonlocal": _mk(
        "re50_eca_nonlocal",
        anchors=CFG_RE50,
        backbone="resnet50",
        backbone_block_attention=None,
        in_channels=(512, 1024, 2048),
        out_channels=256,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
    ),
    # nets/retinaface_eca_nonlocal_droupout.py: re50_eca_nonlocal with
    # F.dropout(p=0.5) on the three backbone taps before the tap ECAs
    # (:322-330). The last of the reference's 14 variants to get a config
    # equivalent. Its eca gate is plain sigmoid (the file drops the
    # Hardsigmoid member its base class had).
    "re50_dropout": _mk(
        "re50_dropout",
        anchors=CFG_RE50,
        backbone="resnet50",
        backbone_block_attention=None,
        in_channels=(512, 1024, 2048),
        out_channels=256,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
        tap_dropout=0.5,
    ),
    # train_50_3_r.py: plain FPN+SSH ResNet-50 baseline.
    "re50_baseline": _mk(
        "re50_baseline",
        anchors=CFG_RE50,
        backbone="resnet50",
        backbone_block_attention=None,
        in_channels=(512, 1024, 2048),
        out_channels=256,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface50_self.py + train_50_4self.py: 4-level resnet50_self.
    "re50_self_4level": _mk(
        "re50_self_4level",
        anchors=CFG_RE50_SELF,
        backbone="resnet50_self",
        backbone_block_attention=None,
        fpn_variant="raw152_5",  # retinaface50_self.py:95 uses FPN_152_5
        ssh_share_level4=True,
        num_levels=4,
        # resnet_pytorch.py:179-186: layer2..5 out channels with the
        # self-mod layer4 at 256 planes (1024 ch) and layer5 at 512 (2048).
        in_channels=(512, 1024, 1024, 2048),
        out_channels=256,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_152.py: ResNet-152 + 4-level FPN_152.
    "re152_4level": _mk(
        "re152_4level",
        anchors=CFG_RE152,
        backbone="resnet152",
        backbone_block_attention=None,
        fpn_variant="raw152",  # retinaface_152.py uses FPN_152
        ssh_share_level4=True,
        num_levels=4,
        in_channels=(256, 512, 1024, 2048),
        out_channels=256,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_att.py: ECA only on the FPN outputs.
    "re50_fpn_att": _mk(
        "re50_fpn_att",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention=None,
        fpn_attention="eca",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_backbone_att.py: ECA on backbone outs + FPN_me.
    "re50_backbone_att": _mk(
        "re50_backbone_att",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention="eca",
        fpn_attention=None,
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_biaocha_eca.py: contrast ("biaocha" = stdv) ECA.
    "re50_contrast_eca": _mk(
        "re50_contrast_eca",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention="eca_stdv",
        fpn_attention="eca_stdv",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_NonLocal.py: NLM-in-FPN only, no ECA anywhere.
    "re50_nonlocal": _mk(
        "re50_nonlocal",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
    ),
    # nets/retinaface_eca_hwish.py: ECA with hardsigmoid gate on resnet50.
    "re50_eca_hsigmoid": _mk(
        "re50_eca_hsigmoid",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="hsigmoid",
        fpn_upsample="nearest",
        nlm=None,
    ),
    # nets/retinaface_IOU.py: + IoU-prediction head.
    "re50_iou_head": _mk(
        "re50_iou_head",
        anchors=CFG_RE50,
        backbone="resnet50",
        in_channels=(512, 1024, 2048),
        out_channels=256,
        backbone_block_attention=None,
        tap_attention="eca",
        fpn_attention="eca",
        eca_gate="sigmoid",
        fpn_upsample="nearest",
        nlm=NLMConfig(ch=4, psp_sizes=(1, 4, 8, 12)),
        with_iou_head=True,
    ),
    # retinaface_training_DIOU.py applied to the flagship: DIoU regression.
    "jabd_flagship_diou": _mk(
        "jabd_flagship_diou",
        anchors=CFG_MNET,
        backbone="mobilenet_v3_large",
        backbone_block_attention="eca",
        in_channels=(40, 80, 160),
        out_channels=40,
        tap_attention="eca_stdv",
        fpn_attention="eca_stdv",
        eca_gate="hsigmoid",
        fpn_upsample="bicubic",
        nlm=NLMConfig(ch=40, psp_sizes=(1, 3, 6, 8)),
        box_loss="diou",
    ),
    # nets/retinaface50_self.py's commented EPSANet alternative backbone.
    "epsa50_4level": _mk(
        "epsa50_4level",
        anchors=CFG_RE50_SELF,
        backbone="epsanet50",
        backbone_block_attention=None,
        fpn_variant="raw152_5",
        ssh_share_level4=True,
        num_levels=4,
        in_channels=(512, 1024, 1024, 2048),
        out_channels=256,
        tap_attention=None,
        fpn_attention=None,
        fpn_upsample="nearest",
        nlm=None,
    ),
}


def get_model_config(name: str) -> ModelConfig:
    try:
        return MODEL_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; available: "
            f"{sorted(MODEL_PRESETS)}"
        ) from None
