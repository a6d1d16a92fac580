"""The reference's PyTorch `.pth` names, in both directions.

Port of `jabd_tpu/utils/torch_convert.py`. A reference checkpoint (a
`.pth` saved by its train scripts, train_mobilenetV3_ecagai.py:545-549)
names its tensors after the reference's own modules (`body.layer1.0.conv1`,
`fpn.output1.0`, `ClassHead.0.conv1x1`, ...); the port names its modules
after the JAX package's flax paths (utils/convert.py). Each model family is
one declarative walk over (reference name, flax path) pairs, executed by a
direction-aware `_Map`; the walks here are the JAX package's, copied, and
they compose with `utils/convert.py` (`state_dict_from_flax`,
`flax_from_state_dict`), so reference name -> port name is the same walk
the JAX package runs and the two directions cannot drift apart.

  convert_state_dict_auto(sd, cfg)         reference dict -> port state dict
  export_state_dict_auto(state_dict, cfg)  port state dict -> reference dict
  load_pth / save_pth                      the .pth file itself

Tensor layouts: conv2d reference [O, I/g, kh, kw] <-> flax [kh, kw, I/g, O]
(the port's own weights are the reference's layout again); conv1d
[1, 1, k] <-> [k, 1, 1]; BatchNorm weight/bias <-> scale/bias and
running_mean/var <-> batch_stats, with num_batches_tracked = 0 on export.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from jabd_tpu_torch.configs import ModelConfig
from jabd_tpu_torch.models.mobilenet import MNV3_LARGE_3STAGE, MNV3_LARGE_4STAGE
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax


def conv2d_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def conv2d_w_inv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def conv1d_w(w: np.ndarray) -> np.ndarray:
    # torch [1, 1, k] <-> flax [k, 1, 1]: the reversal permutation is its
    # own inverse.
    return np.transpose(w, (2, 1, 0))


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _get(tree: Dict, path: Tuple[str, ...]) -> np.ndarray:
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node)


def _has(tree: Dict, path: Tuple[str, ...]) -> bool:
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


class _Map:
    """Executes one family walk in either direction.

    forward (reverse=False): reads `sd` (torch state dict), fills
    (params, stats). reverse: reads (params, stats), fills `sd`.
    """

    def __init__(self, sd, params, stats, reverse: bool = False):
        self.sd = sd
        self.params = params
        self.stats = stats
        self.reverse = reverse

    # -- presence checks (consult whichever side is the source) ---------
    def have(self, torch_key: str, flax_path: Tuple[str, ...]) -> bool:
        if self.reverse:
            return _has(self.params, flax_path)
        return torch_key in self.sd

    # -- leaf movers ----------------------------------------------------
    def _leaf(self, torch_key, tree, flax_path, fwd=None, inv=None):
        if self.reverse:
            v = _get(tree, flax_path)
            self.sd[torch_key] = inv(v) if inv else np.asarray(v)
        else:
            v = np.asarray(self.sd[torch_key])
            _set(tree, flax_path, fwd(v) if fwd else v)

    def param(self, torch_key, flax_path, fwd=None, inv=None):
        self._leaf(torch_key, self.params, flax_path, fwd, inv)

    def stat(self, torch_key, flax_path):
        self._leaf(torch_key, self.stats, flax_path)

    def bn(self, torch_bn: str, flax_path: Tuple[str, ...]) -> None:
        self.param(torch_bn + ".weight", flax_path + ("scale",))
        self.param(torch_bn + ".bias", flax_path + ("bias",))
        self.stat(torch_bn + ".running_mean", flax_path + ("mean",))
        self.stat(torch_bn + ".running_var", flax_path + ("var",))
        if self.reverse:
            self.sd[torch_bn + ".num_batches_tracked"] = np.asarray(
                0, np.int64
            )

    def convbn(self, torch_conv, torch_bn, flax_path):
        """A torch conv+bn pair <-> a jabd ConvBN module."""
        self.param(
            torch_conv + ".weight",
            flax_path + ("conv", "kernel"),
            conv2d_w,
            conv2d_w_inv,
        )
        self.bn(torch_bn, flax_path + ("bn",))

    def eca(self, torch_prefix, flax_path):
        self.param(
            torch_prefix + ".conv.weight",
            flax_path + ("conv1d", "kernel"),
            conv1d_w,
            conv1d_w,
        )

    def conv_with_bias(self, torch_prefix, flax_path):
        self.param(
            torch_prefix + ".weight",
            flax_path + ("kernel",),
            conv2d_w,
            conv2d_w_inv,
        )
        self.param(torch_prefix + ".bias", flax_path + ("bias",))


# ---------------------------------------------------------------------------
# Family walks
# ---------------------------------------------------------------------------


def _walk_flagship(m: _Map, cfg: ModelConfig) -> None:
    """Flagship JABD assembly (inline RetinaFace of
    train_mobilenetV3_ecagai.py:319-435, also nets/retinaface_r.py):
    IntermediateLayerGetter'd MobileNetV3 (`body.*`), external ECA taps,
    the NLM FPN, eca_fpn, SSH heads, prediction head stacks."""
    m.convbn("body.conv1", "body.bn1", ("backbone", "stem"))

    stages = MNV3_LARGE_4STAGE if cfg.num_levels == 4 else MNV3_LARGE_3STAGE
    for si, stage in enumerate(stages):
        for bi, (k, cin, exp, cout, act, se, stride) in enumerate(stage):
            t = f"body.layer{si + 1}.{bi}"
            f = ("backbone", f"layer{si + 1}_block{bi}")
            m.convbn(f"{t}.conv1", f"{t}.bn1", f + ("conv1",))
            m.convbn(f"{t}.conv2", f"{t}.bn2", f + ("conv2",))
            m.convbn(f"{t}.conv3", f"{t}.bn3", f + ("conv3",))
            if cfg.backbone_block_attention:
                m.eca(f"{t}.eca", f + ("eca",))
            elif se:
                # Plain Block applies SE: se.se = [pool, conv, bn, relu,
                # conv, hsig] (nets/mobilenetV3.py:22-29).
                m.param(
                    f"{t}.se.se.1.weight",
                    f + ("se", "fc1", "kernel"),
                    conv2d_w,
                    conv2d_w_inv,
                )
                m.bn(f"{t}.se.se.2", f + ("se", "bn"))
                m.param(
                    f"{t}.se.se.4.weight",
                    f + ("se", "fc2", "kernel"),
                    conv2d_w,
                    conv2d_w_inv,
                )
            # skip path (nets/mobilenetV3.py:117-138)
            if stride == 1 and cin != cout:
                m.convbn(f"{t}.skip.0", f"{t}.skip.1", f + ("skip_conv",))
            elif stride == 2 and cin != cout:
                m.convbn(f"{t}.skip.0", f"{t}.skip.1", f + ("skip_dw",))
                m.conv_with_bias(f"{t}.skip.2", f + ("skip_pw",))
                m.bn(f"{t}.skip.3", f + ("skip_pw_bn",))
            elif stride == 2 and cin == cout:
                m.convbn(f"{t}.skip.0", f"{t}.skip.1", f + ("skip_dw",))

    _walk_common(m, cfg)


def _walk_common(
    m: _Map,
    cfg: ModelConfig,
    tap_eca_names: Tuple[str, ...] = (),
    nlm_name: str = "nlm",
) -> None:
    """FPN / NLM / eca taps / SSH / heads — shared by every detector
    assembly (flagship inline model, retinaface_eca_nonlocal.py, ...).

    Sections absent on the source side are skipped: the reference also
    loads backbone-only pretrained checkpoints
    (nets/retinaface_r.py:238-246 strips and loads just the backbone)."""
    # --- external tap ECAs. Flagship names them by tap channel count
    # (eca_40/80/160); the resnet50 eca_nonlocal model keeps legacy names
    # eca_64/128/256 despite 512/1024/2048 channels
    # (nets/retinaface_eca_nonlocal.py:280-282).
    if cfg.tap_attention:
        names = tap_eca_names or tuple(
            f"eca_{ch}" for ch in cfg.in_channels[: cfg.num_levels]
        )
        for i, name in enumerate(names):
            if m.have(f"{name}.conv.weight", (f"eca_tap{i + 1}",)):
                m.eca(name, (f"eca_tap{i + 1}",))

    # --- FPN ---
    if not m.have("fpn.output1.0.weight", ("fpn",)):
        return  # backbone-only checkpoint
    for i in range(cfg.num_levels):
        m.convbn(
            f"fpn.output{i + 1}.0",
            f"fpn.output{i + 1}.1",
            ("fpn", f"output{i + 1}"),
        )
    if cfg.fpn_variant == "cascade":
        for i in range(cfg.num_levels - 1):
            m.convbn(
                f"fpn.merge{i + 1}.0",
                f"fpn.merge{i + 1}.1",
                ("fpn", f"merge{i + 1}"),
            )
    else:
        # FPN_152/FPN_152_5 share one live merge conv named merge2
        # (their merge1 is dead — nets/layers.py:184-185,240,305).
        m.convbn("fpn.merge2.0", "fpn.merge2.1", ("fpn", "merge_shared"))
    if cfg.nlm is not None:
        # torch attribute case differs per family: the mobilenet/JABD
        # assemblies name it `fpn.nlm` (retinaface_r.py:167,
        # train_mobilenetV3_ecagai.py:244) while the resnet assemblies
        # capitalize `fpn.Nlm` (retinaface_eca_nonlocal.py:50,
        # retinaface_NonLocal.py, retinaface_eca_hwish.py). Getting this
        # wrong silently DROPS trained NLM weights on import (zero-init W
        # masks it at random init — caught by the round-4 pipeline test).
        for name in ("f_query", "f_key", "f_value", "W"):
            m.conv_with_bias(f"fpn.{nlm_name}.{name}", ("fpn", "nlm", name))
    if cfg.fpn_upsample == "pixelshuffle":
        # Learned sub-pixel upsample (the train_all_bicubic.py:231-271
        # pixelshuffle_block sketch): one conv shared across levels; torch
        # naming follows that sketch's conv-before-PixelShuffle layout.
        m.conv_with_bias("fpn.pix.conv", ("fpn", "pix", "conv"))
    if cfg.fpn_attention:
        m.eca("eca_fpn", ("eca_fpn",))

    # --- SSH ---
    ssh_pairs = [
        ("conv3X3", "conv3x3"),
        ("conv5X5_1", "conv5x5_1"),
        ("conv5X5_2", "conv5x5_2"),
        ("conv7X7_2", "conv7x7_2"),
        ("conv7x7_3", "conv7x7_3"),  # ref lowercase x here (layers.py:54)
    ]
    # ssh_share_level4: level 4 reuses ssh3's weights in the reference
    # forward (retinaface_152.py:154) — its ssh4/ssh5 params are dead and
    # must NOT be converted (our shared graph has no ssh4 module).
    n_ssh = 3 if cfg.ssh_share_level4 else cfg.num_levels
    for i in range(n_ssh):
        for tname, fname in ssh_pairs:
            m.convbn(
                f"ssh{i + 1}.{tname}.0",
                f"ssh{i + 1}.{tname}.1",
                (f"ssh{i + 1}", fname),
            )

    # --- heads ---
    for i in range(cfg.num_levels):
        m.conv_with_bias(
            f"ClassHead.{i}.conv1x1", (f"class_head{i + 1}", "conv1x1")
        )
        m.conv_with_bias(
            f"BboxHead.{i}.conv1x1", (f"bbox_head{i + 1}", "conv1x1")
        )
        m.conv_with_bias(
            f"LandmarkHead.{i}.conv1x1",
            (f"landmark_head{i + 1}", "conv1x1"),
        )
    if cfg.with_iou_head:
        # Per-level IoU heads (re50_iou_head preset). The reference's
        # _make_IOU_head builds a single [BboxHead, IOUHead] pair and
        # never calls it in forward (retinaface_IOU.py:131-137,
        # SURVEY 2.1) — our applied per-level heads export under the
        # natural per-level extension of that naming.
        for i in range(cfg.num_levels):
            m.conv_with_bias(
                f"IOUHead.{i}.conv1x1", (f"iou_head{i + 1}", "conv1x1")
            )


def _walk_resnet(
    m: _Map,
    cfg: ModelConfig,
    tap_eca_names: Tuple[str, ...] = ("eca_64", "eca_128", "eca_256"),
) -> None:
    """ResNet-backbone detectors (the predict.py model
    nets/retinaface_eca_nonlocal.py and the train_50_* baselines):
    body.conv1/bn1 + body.layer{s}.{i}.conv{1..3}/bn{1..3}
    [+ downsample.0/.1] (torchvision ResNet via IntermediateLayerGetter),
    then the common fpn/ssh/head surface."""
    from jabd_tpu_torch.models.resnet import RESNET_SPECS

    m.convbn("body.conv1", "body.bn1", ("backbone", "stem"))
    rn_name = cfg.backbone
    if rn_name == "resnet152" and cfg.num_levels == 4:
        rn_name = "resnet152_l4"
    blocks, planes, _ = RESNET_SPECS[rn_name]
    in_ch = 64
    for si, (nblocks, p) in enumerate(zip(blocks, planes)):
        stride = 1 if si == 0 else 2
        for bi in range(nblocks):
            t = f"body.layer{si + 1}.{bi}"
            f = ("backbone", f"layer{si + 1}_block{bi}")
            for c in (1, 2, 3):
                m.convbn(f"{t}.conv{c}", f"{t}.bn{c}", f + (f"conv{c}",))
            s = stride if bi == 0 else 1
            if bi == 0 and (s != 1 or in_ch != p * 4):
                m.convbn(
                    f"{t}.downsample.0",
                    f"{t}.downsample.1",
                    f + ("downsample",),
                )
            in_ch = p * 4

    _walk_common(m, cfg, tap_eca_names=tap_eca_names, nlm_name="Nlm")


def _walk_epsa(
    m: _Map,
    cfg: ModelConfig,
    blocks: Optional[Tuple[int, ...]] = None,
    planes: Optional[Tuple[int, ...]] = None,
) -> None:
    """EPSANet-backbone detectors (the retinaface50_self.py
    `backbone = epsa50` branch, nets/EPSA50.py). torch names per
    EPSABlock (EPSA50.py:77-116): conv1/bn1, conv2 = PSAModule
    {conv_1..4, se.fc1/fc2}, bn2, conv3/bn3, downsample.0/.1."""
    from jabd_tpu_torch.models import epsa

    m.convbn("body.conv1", "body.bn1", ("backbone", "stem"))
    blocks = blocks if blocks is not None else epsa.EPSANET50_SPEC[0]
    planes = planes if planes is not None else epsa.EPSANET50_SPEC[1]
    in_ch = 64
    for si, (nblocks, p) in enumerate(zip(blocks, planes)):
        stride = 1 if si == 0 else 2
        for bi in range(nblocks):
            t = f"body.layer{si + 1}.{bi}"
            f = ("backbone", f"layer{si + 1}_block{bi}")
            m.convbn(f"{t}.conv1", f"{t}.bn1", f + ("conv1",))
            for c in range(1, 5):
                m.param(
                    f"{t}.conv2.conv_{c}.weight",
                    f + ("psa", f"conv_{c}", "kernel"),
                    conv2d_w,
                    conv2d_w_inv,
                )
            m.conv_with_bias(f"{t}.conv2.se.fc1", f + ("psa", "se", "fc1"))
            m.conv_with_bias(f"{t}.conv2.se.fc2", f + ("psa", "se", "fc2"))
            m.bn(f"{t}.bn2", f + ("bn2",))
            m.convbn(f"{t}.conv3", f"{t}.bn3", f + ("conv3",))
            s = stride if bi == 0 else 1
            if bi == 0 and (s != 1 or in_ch != p * 4):
                m.convbn(
                    f"{t}.downsample.0",
                    f"{t}.downsample.1",
                    f + ("downsample",),
                )
            in_ch = p * 4

    _walk_common(m, cfg)


def _walk_mnet025(m: _Map, cfg: ModelConfig) -> None:
    """Vanilla-RetinaFace MobileNetV1-0.25 — the most widely distributed
    pretrained family for this codebase (predict.py:80-85 backbone
    'mobilenet0.25' path). torch names (nets/retinaface.py:64 +
    nets/mobilenet025.py:21 under IntermediateLayerGetter):
    body.stage1.0 is the conv_bn stem (Sequential [conv, bn, leaky]);
    conv_dw blocks (Sequential [dw conv, bn, leaky, pw conv, bn, leaky])
    at body.stage1.{1..5}, body.stage2.{0..5}, body.stage3.{0..1}."""
    m.convbn("body.stage1.0.0", "body.stage1.0.1", ("backbone", "stem"))
    dw = 0
    for stage, first, count in (
        ("stage1", 1, 5),
        ("stage2", 0, 6),
        ("stage3", 0, 2),
    ):
        for k in range(first, first + count):
            t = f"body.{stage}.{k}"
            m.convbn(f"{t}.0", f"{t}.1", ("backbone", f"dw{dw}_depth"))
            m.convbn(f"{t}.3", f"{t}.4", ("backbone", f"dw{dw}_point"))
            dw += 1

    _walk_common(m, cfg)


def _walk_for(cfg: ModelConfig):
    """Family walk for a preset's backbone (shared by both directions)."""
    if cfg.backbone == "mobilenet_v1_025":
        return _walk_mnet025
    if cfg.backbone == "mobilenet_v3_large":
        return _walk_flagship
    if cfg.backbone.startswith("resnet"):
        return _walk_resnet
    if cfg.backbone == "epsanet50":
        return _walk_epsa
    raise ValueError(f"no torch converter for backbone {cfg.backbone!r}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _to_flax(sd: Mapping, cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """Reference names -> (params, batch_stats) flax trees."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    walk = _walk_for(cfg)
    if walk is _walk_mnet025 and "body.stage1.0.0.weight" not in sd and "stage1.0.0.weight" in sd:
        # Backbone-only pretrain checkpoint (the mobilenetV1X0.25_pretrain
        # .tar family, 'stage1...' without the 'body.' prefix): normalize
        # to detector names.
        sd = {("body." + k if k.startswith("stage") else k): v for k, v in sd.items()}
    m = _Map(sd, {}, {})
    walk(m, cfg)
    return m.params, m.stats


def convert_state_dict_auto(sd: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference state dict (numpy or tensor values) -> the port's state
    dict, by the preset's backbone family: mobilenet_v1_025 (stage1..3
    conv_bn / conv_dw names), mobilenet_v3_large (flagship body.layerN
    blocks), resnet* (torchvision ResNet detectors), epsanet50. A
    backbone-only checkpoint gives the backbone's entries only."""
    params, stats = _to_flax(sd, cfg)
    return state_dict_from_flax({"params": params, "batch_stats": stats})


def export_state_dict_auto(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's state dict -> a reference state dict (numpy values,
    float32; num_batches_tracked 0), the exact inverse of
    `convert_state_dict_auto`. Load it into the reference's own module with
    strict=False: the reference keeps parameters no forward reads
    (FPN_152's merge1, ssh4/ssh5 under share_level4, Block_eca's unapplied
    SE).

    Expects an unfolded state dict (a training checkpoint); raises
    ValueError for a BatchNorm-folded one, which has no BatchNorm left to
    export."""
    variables = flax_from_state_dict(state_dict)
    if not _has(variables["params"], ("backbone", "stem", "bn")):
        raise ValueError(
            "state dict looks BN-folded (no backbone.stem.bn): export the "
            "unfolded training checkpoint, not the folded serving model"
        )
    m = _Map({}, variables["params"], variables["batch_stats"], reverse=True)
    _walk_for(cfg)(m, cfg)
    return m.sd


def save_pth(sd: Mapping[str, np.ndarray], path: str) -> None:
    """torch.save an exported state dict (the reference's checkpoint
    format, utils_fit_change.py:60-63)."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A .pth / .tar state dict as numpy: a {"state_dict": ...} wrapper is
    unwrapped and DataParallel's `module.` prefix dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k[7:] if k.startswith("module.") else k
        out[k] = v.detach().numpy()
    return out
