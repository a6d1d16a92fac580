"""IR / IR-SE embedding backbones, NCHW `nn.Module`s.

Port of `jabd_tpu/recognition/net.py`: `PReLU`, `SEBlock`,
`BasicBlockIR`, `BottleneckIRBlock`, `IRBackbone` (112x112 -> (unit-norm
512-d embedding, norm)) and `build_model` with the 12 names. Submodule and
parameter names mirror the flax paths (`stage2_block0.shortcut_conv.weight`,
`input_prelu.alpha`, `features_bn.running_mean`), so `utils/convert.py`
carries weights between the two packages.

The graph computes in the dtype of its parameters (float32 as built, or
`model.to(torch.bfloat16)` after folding, as the detector's presets do),
or in bfloat16 under torch.autocast with float32 parameters (the train
step's `--precision 16`); the embedding is normalized in float32 at the
end. In training mode the BatchNorms keep flax's running variance
(`models/layers.BatchNorm2d` / `BatchNorm1d`) and the dropout before `fc`
draws its mask from the generator the caller passes.

Folding (`recognition/fold.py`) sets a conv's BatchNorm attribute to None
and gives the conv a bias; int8 quantization (`models/quantize.py`) then
replaces the conv by a `QConv` and `fc` by a `QDense`. The forward calls
whatever module sits in each slot, so the folded and int8 graphs need no
flag: the counterpart of the JAX package's detection of a folded or int8
parameter tree at apply time.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d, fold_conv_bn
from jabd_tpu_torch.models.retinaface import DTYPES

# Module names of the convs and the projection that int8 quantizes (the
# JAX package's `quant_calib` sow sites).
QUANT_SITES = ("input_conv", "conv1", "conv2", "conv3", "shortcut_conv", "fc")


class PReLU(nn.Module):
    """Per-channel PReLU, where(x >= 0, x, alpha * x), alpha initialised to
    0.25 (torch nn.PReLU(C)). `F.prelu` computes the same values (x where
    x > 0, else the one product alpha * x, which is x at x = 0) in one
    kernel."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.alpha.to(x.dtype))


class SEBlock(nn.Module):
    """Squeeze-excite with reduction 16: spatial mean -> fc1 -> relu -> fc2
    -> sigmoid gate; both 1x1 convs bias-free."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        y = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(y)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


def _fold(conv: nn.Module, bn: Optional[nn.Module]) -> nn.Module:
    return conv if bn is None else fold_conv_bn(conv, bn)


def _bn(bn: Optional[nn.Module], x):
    return x if bn is None else bn(x)


class _IRBlock(nn.Module):
    """What both IR blocks share: the pre-activation `bn0`, the optional SE
    gate and the shortcut, a strided slice (MaxPool2d(1, stride)) when the
    channels stay, else a strided 1x1 conv + BatchNorm."""

    def __init__(self, cin: int, depth: int, stride: int, se: bool):
        super().__init__()
        self.stride = stride
        self.bn0 = BatchNorm2d(cin)
        self.se = SEBlock(depth) if se else None
        if cin != depth:
            self.shortcut_conv = _conv(cin, depth, 1, stride)
            self.shortcut_bn: Optional[nn.Module] = BatchNorm2d(depth)
        else:
            self.shortcut_conv = None
            self.shortcut_bn = None

    def _fold_shortcut(self) -> None:
        if self.shortcut_conv is not None:
            self.shortcut_conv = _fold(self.shortcut_conv, self.shortcut_bn)
            self.shortcut_bn = None

    def _out(self, res, x):
        if self.se is not None:
            res = self.se(res)
        if self.shortcut_conv is None:
            short = x[:, :, :: self.stride, :: self.stride]
        else:
            short = _bn(self.shortcut_bn, self.shortcut_conv(x))
        return res + short


class BasicBlockIR(_IRBlock):
    """BN -> conv3x3 -> BN -> PReLU -> conv3x3 (stride) -> BN (-> SE) +
    shortcut."""

    def __init__(self, cin: int, depth: int, stride: int, se: bool = False):
        super().__init__(cin, depth, stride, se)
        self.conv1 = _conv(cin, depth, 3)
        self.bn1: Optional[nn.Module] = BatchNorm2d(depth)
        self.prelu = PReLU(depth)
        self.conv2 = _conv(depth, depth, 3, stride)
        self.bn2: Optional[nn.Module] = BatchNorm2d(depth)

    def fold_(self) -> None:
        self.conv1, self.bn1 = _fold(self.conv1, self.bn1), None
        self.conv2, self.bn2 = _fold(self.conv2, self.bn2), None
        self._fold_shortcut()

    def forward(self, x):
        res = self.prelu(_bn(self.bn1, self.conv1(self.bn0(x))))
        res = _bn(self.bn2, self.conv2(res))
        return self._out(res, x)


class BottleneckIRBlock(_IRBlock):
    """BN -> 1x1 (depth/4) -> BN -> PReLU -> 3x3 -> BN -> PReLU -> 1x1
    (depth, stride) -> BN (-> SE) + shortcut: the stride sits on the LAST
    1x1 conv, as in the reference."""

    def __init__(self, cin: int, depth: int, stride: int, se: bool = False):
        super().__init__(cin, depth, stride, se)
        red = depth // 4
        self.conv1 = _conv(cin, red, 1)
        self.bn1: Optional[nn.Module] = BatchNorm2d(red)
        self.prelu1 = PReLU(red)
        self.conv2 = _conv(red, red, 3)
        self.bn2: Optional[nn.Module] = BatchNorm2d(red)
        self.prelu2 = PReLU(red)
        self.conv3 = _conv(red, depth, 1, stride)
        self.bn3: Optional[nn.Module] = BatchNorm2d(depth)

    def fold_(self) -> None:
        self.conv1, self.bn1 = _fold(self.conv1, self.bn1), None
        self.conv2, self.bn2 = _fold(self.conv2, self.bn2), None
        self.conv3, self.bn3 = _fold(self.conv3, self.bn3), None
        self._fold_shortcut()

    def forward(self, x):
        res = self.prelu1(_bn(self.bn1, self.conv1(self.bn0(x))))
        res = self.prelu2(_bn(self.bn2, self.conv2(res)))
        res = _bn(self.bn3, self.conv3(res))
        return self._out(res, x)


# (depth, num_units) per stage.
IR_STAGES = {
    18: [(64, 2), (128, 2), (256, 2), (512, 2)],
    34: [(64, 3), (128, 4), (256, 6), (512, 3)],
    50: [(64, 3), (128, 4), (256, 14), (512, 3)],
    100: [(64, 3), (128, 13), (256, 30), (512, 3)],
    152: [(256, 3), (512, 8), (1024, 36), (2048, 3)],
    200: [(256, 3), (512, 24), (1024, 36), (2048, 3)],
}


class IRBackbone(nn.Module):
    """[B, 3, 112, 112] RGB in [-1, 1] -> (unit-norm [B, 512] embedding,
    [B, 1] norm), both float32."""

    def __init__(self, num_layers: int = 50, mode: str = "ir", embedding_size: int = 512,
                 dropout: float = 0.4, image_size: int = 112):
        super().__init__()
        if num_layers not in IR_STAGES:
            raise ValueError(f"num_layers must be one of {sorted(IR_STAGES)}, got {num_layers}")
        self.num_layers, self.mode, self.embedding_size = num_layers, mode, embedding_size
        se = mode == "ir_se"
        block = BottleneckIRBlock if num_layers > 100 else BasicBlockIR
        self.input_conv = _conv(3, 64, 3)
        self.input_bn: Optional[nn.Module] = BatchNorm2d(64)
        self.input_prelu = PReLU(64)
        cin = 64
        for si, (depth, units) in enumerate(IR_STAGES[num_layers]):
            for bi in range(units):
                self.add_module(f"stage{si + 1}_block{bi}", block(cin, depth, 2 if bi == 0 else 1, se))
                cin = depth
        self.output_bn = BatchNorm2d(cin)
        self.dropout = dropout
        side = image_size
        for _ in IR_STAGES[num_layers]:  # each stage halves the side, rounding up
            side = -(-side // 2)
        self.fc = nn.Linear(cin * side * side, embedding_size)
        self.features_bn: Optional[nn.Module] = BatchNorm1d(embedding_size, affine=False)

    def blocks(self):
        return [m for n, m in self.named_children() if n.startswith("stage")]

    def quant_sites(self):
        """{module name: module} of the int8 calibration sites, in forward
        order (models/quantize.py)."""
        return {n: m for n, m in self.named_modules() if n.rpartition(".")[2] in QUANT_SITES}

    def fold_(self) -> None:
        self.input_conv, self.input_bn = _fold(self.input_conv, self.input_bn), None
        if self.features_bn is not None:
            from jabd_tpu_torch.recognition.fold import fold_linear_bn

            self.fc, self.features_bn = fold_linear_bn(self.fc, self.features_bn), None

    def _dropout(self, h, generator: Optional[torch.Generator]):
        """flax Dropout in training mode: keep each value with probability
        1 - p and scale it by 1 / (1 - p), the mask drawn from `generator`
        (torch's default generator when None); the identity in eval mode."""
        if not self.training or self.dropout <= 0.0:
            return h
        keep = 1.0 - self.dropout
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """`generator` draws the dropout mask in training mode (a
        torch.Generator on x's device)."""
        x = x.to(self.output_bn.weight.dtype)
        h = self.input_prelu(_bn(self.input_bn, self.input_conv(x)))
        for blk in self.blocks():
            h = blk(h)
        # The JAX package transposes NHWC to CHW before its flatten so that
        # the reference's Linear weights line up; in NCHW that is the
        # identity.
        h = self._dropout(self.output_bn(h), generator).flatten(1)
        h = _bn(self.features_bn, self.fc(h)).float()
        norm = torch.linalg.vector_norm(h, dim=1, keepdim=True)
        return h / norm, norm


BUILD_TABLE = {
    "ir_18": (18, "ir"),
    "ir_34": (34, "ir"),
    "ir_50": (50, "ir"),
    "ir_101": (100, "ir"),  # "ir_101" uses the 100-layer stages
    "ir_152": (152, "ir"),
    "ir_200": (200, "ir"),
    "ir_se_18": (18, "ir_se"),
    "ir_se_34": (34, "ir_se"),
    "ir_se_50": (50, "ir_se"),
    "ir_se_101": (100, "ir_se"),
    "ir_se_152": (152, "ir_se"),
    "ir_se_200": (200, "ir_se"),
}


def build_model(name: str = "ir_50", dtype="float32", device=None) -> IRBackbone:
    """The IR backbone `name` in eval mode on `device` (the card unless
    given), its parameters in `dtype` ("float32" or "bfloat16", or a torch
    dtype). Raises ValueError for an unknown name."""
    if name not in BUILD_TABLE:
        raise ValueError(f"not a correct model name {name!r}")
    layers, mode = BUILD_TABLE[name]
    dt = DTYPES[dtype] if isinstance(dtype, str) else dtype
    return IRBackbone(num_layers=layers, mode=mode).to(resolve_device(device), dt).eval()
