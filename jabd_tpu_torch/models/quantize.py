"""Post-training int8 quantization of a folded eval model (serving).

Port of `jabd_tpu/models/quantize.py` (`qconv_apply`, `qdense_apply`,
`calibrate`, `_quantize_site`, `quantize_variables`, `search_clip_ratio`)
and of the int8 branches of its `ConvBN` and of the IR backbones
(recognition/net.py). The recipe is the JAX package's:

  * It builds on BatchNorm folding (models/fold.py): a folded `ConvBN` is
    a conv with bias. Quantization replaces its `conv` with a `QConv`
    holding an int8 kernel, per-output-channel weight scales, one input
    activation scale and the float bias.
  * Weights: symmetric per output channel, absmax / 127, computed in numpy
    from the folded weights as the model holds them (bfloat16 values for a
    bfloat16 preset), so the scales and int8 kernels are bit-equal to the
    JAX package's on the same folded tree.
  * Activations: symmetric per tensor, absmax / 127, the absmax of each
    site's input over sample batches (`calibrate`: forward pre-hooks, the
    counterpart of the JAX package's `quant_calib` sow). The sites are
    every `ConvBN` of a detector, and the convs and the projection `fc`
    of an IR backbone (its `quant_sites()`: the JAX package's flat layout,
    a folded {kernel, bias} beside its `<name>_absmax`). There a folded
    conv becomes a `QConv` and `fc` a `QDense` (int8 x int8 -> int32
    matmul, then dequantization plus bias).
  * Depthwise convs (one input channel per group) stay in floating point,
    as do sites whose input never left 0, as in the JAX package.

A `QConv` computes x_q = clamp(round(x / x_scale), -127, 127) as int8
(`torch.round` rounds half to even, as `jnp.round` does), an int8 conv
summed exactly in int32, then y * (w_scale * x_scale) + bias in float32,
cast to the model's dtype. The int32 conv (the JAX package leaves it to
XLA; it is no TPU kernel) runs

  * on the card as im2col (strided views, one copy) and `torch._int_mm`
    (int8 tensor cores, int32 sums), with K, N and M zero-padded to what
    `_int_mm` takes (K and N multiples of 8, M above 16): zero rows and
    columns add nothing, so the result is exact;
  * on the CPU (`int8_conv_plain`, the plain version the card's route is
    held against) as a float64 conv of the int8 values: every partial sum
    is an integer below 127^2 * K < 2^53, so it is exact too.

A `QDense` takes the same two routes without the im2col
(`int8_matmul_mm`, `int8_matmul_plain`).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jabd_tpu_torch.models.layers import ConvBN


def int8_conv_plain(x_q, kernel_q, stride: int, padding: int, groups: int) -> torch.Tensor:
    """int32 conv of int8 x_q [B, C, H, W] and kernel_q [O, C/g, k, k]: a
    float64 conv of the int8 values (exact, see the module note)."""
    y = F.conv2d(x_q.double(), kernel_q.double(), stride=stride, padding=padding, groups=groups)
    return y.to(torch.int32)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_matmul_plain(x_q, kernel_q) -> torch.Tensor:
    """int32 x_q [M, K] @ kernel_q [N, K].T as a float64 matmul of the int8
    values (exact, see the module note)."""
    return (x_q.double() @ kernel_q.double().t()).to(torch.int32)


def int8_matmul_mm(x_q, kernel_q) -> torch.Tensor:
    """The same int32 matmul through `torch._int_mm` (the card's route),
    with K and N zero-padded to multiples of 8 and M to at least 17."""
    m, k = x_q.shape
    n = kernel_q.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(_pad_to(x_q, 1, kp), 0, mp)
    w = _pad_to(_pad_to(kernel_q, 1, kp), 0, np_)
    return torch._int_mm(a, w.t())[:m, :n]


def int8_conv_mm(x_q, kernel_q, stride: int, padding: int, groups: int) -> torch.Tensor:
    """The same int32 conv as im2col and `torch._int_mm` per group: rows
    are output pixels (B * Ho * Wo), columns the taps (C/g * k * k). The
    card's route; on the CPU `_int_mm` runs too, which the tests use."""
    b, c, h, w = x_q.shape
    o, cg, kh, kw = kernel_q.shape
    og = o // groups
    xp = F.pad(x_q, (padding,) * 4) if padding else x_q
    cols = xp.unfold(2, kh, stride).unfold(3, kw, stride)  # [B, C, Ho, Wo, kh, kw]
    ho, wo = cols.shape[2], cols.shape[3]
    m, k = b * ho * wo, cg * kh * kw
    outs = []
    for g in range(groups):
        a = cols[:, g * cg : (g + 1) * cg].permute(0, 2, 3, 1, 4, 5).reshape(m, k)
        outs.append(int8_matmul_mm(a, kernel_q[g * og : (g + 1) * og].reshape(og, k)))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(b, ho, wo, o).permute(0, 3, 1, 2).contiguous()


class _QSite(nn.Module):
    """What `QConv` and `QDense` share: the int8 quantization of the input
    and the dequantization of the int32 result, per output channel on
    dimension 1."""

    def __init__(self, kernel_q, w_scale, x_scale, bias, out_dtype):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("x_scale", x_scale)
        self.register_buffer("bias", bias)
        self.out_dtype = out_dtype

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x.float() / self.x_scale), -127.0, 127.0).to(torch.int8)

    def dequantize(self, y: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (y.dim() - 2)
        scale = (self.w_scale * self.x_scale).reshape(shape)
        return (y.float() * scale + self.bias.reshape(shape)).to(self.out_dtype)


class QDense(_QSite):
    """The int8 projection of a quantized IR backbone (`qdense_apply`).
    Buffers: `kernel_q` int8 [O, I] (Linear layout), `w_scale` float32 [O],
    `x_scale` float32 [], `bias` float32 [O]."""

    def int_matmul(self, x_q: torch.Tensor) -> torch.Tensor:
        """int32 matmul: the float64 plain version for a CPU tensor, the
        `_int_mm` route for a CUDA tensor."""
        fn = int8_matmul_plain if x_q.device.type == "cpu" else int8_matmul_mm
        return fn(x_q, self.kernel_q)

    def forward(self, x):
        return self.dequantize(self.int_matmul(self.quantize_input(x)))


class QConv(_QSite):
    """The int8 conv of a quantized `ConvBN` (counterpart of the JAX
    ConvBN's `qconv` subtree and `qconv_apply`). Buffers: `kernel_q` int8
    [O, C/g, k, k], `w_scale` float32 [O], `x_scale` float32 [], `bias`
    float32 [O]. The output is cast to `out_dtype`, the dtype of the conv
    it replaced (quantize after any `.to(dtype)` of the model)."""

    def __init__(self, kernel_q, w_scale, x_scale, bias, stride: int, padding: int, groups: int, out_dtype):
        super().__init__(kernel_q, w_scale, x_scale, bias, out_dtype)
        self.stride, self.padding, self.groups = stride, padding, groups

    def int_conv(self, x_q: torch.Tensor) -> torch.Tensor:
        """int32 conv: the float64 plain version for a CPU tensor, the
        `_int_mm` route for a CUDA tensor."""
        fn = int8_conv_plain if x_q.device.type == "cpu" else int8_conv_mm
        return fn(x_q, self.kernel_q, self.stride, self.padding, self.groups)

    def forward(self, x):
        return self.dequantize(self.int_conv(self.quantize_input(x)))


def _sites(model: nn.Module) -> Dict[str, nn.Module]:
    """{module name: module} of the calibration sites: the model's own
    `quant_sites()` (an IR backbone), else every `ConvBN`."""
    own = getattr(model, "quant_sites", None)
    if own is not None:
        return own()
    return {n: m for n, m in model.named_modules() if isinstance(m, ConvBN)}


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Run NCHW sample batches through the eval model, recording the
    absolute maximum of every site's input (in the input's own dtype),
    merged by max over batches. Returns {module name: absmax}."""
    seen: Dict[str, torch.Tensor] = {}

    def tap(name):
        def hook(_, args):
            amax = args[0].detach().abs().amax()
            seen[name] = amax if name not in seen else torch.maximum(seen[name], amax)

        return hook

    hooks = [m.register_forward_pre_hook(tap(n)) for n, m in _sites(model).items()]
    n = 0
    try:
        with torch.inference_mode():
            for x in batches:
                model(x)
                n += 1
    finally:
        for h in hooks:
            h.remove()
    if n == 0:
        raise ValueError("calibrate: no batches provided")
    return {name: float(v) for name, v in seen.items()}


def quantize_site(conv: nn.Conv2d, absmax: float, clip_ratio: float = 1.0) -> QConv:
    """`_quantize_site` of the JAX package on a folded conv: the same numpy
    arithmetic on the same values (OIHW here, HWIO there; the reduction
    runs over every axis but the output channel either way)."""
    k = conv.weight.detach().cpu().float().numpy()
    w_absmax = np.max(np.abs(k), axis=(1, 2, 3))
    w_scale = np.maximum(w_absmax, 1e-12) / 127.0
    kernel_q = np.clip(np.round(k / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
    x_scale = max(float(absmax) * clip_ratio, 1e-12) / 127.0
    dev = conv.weight.device
    return QConv(
        torch.from_numpy(kernel_q).to(dev),
        torch.from_numpy(w_scale.astype(np.float32)).to(dev),
        torch.tensor(x_scale, dtype=torch.float32, device=dev),
        conv.bias.detach().float().clone(),
        conv.stride[0], conv.padding[0], conv.groups, conv.weight.dtype,
    )


def quantize_dense(fc: nn.Linear, absmax: float, clip_ratio: float = 1.0) -> QDense:
    """`_quantize_site` of the JAX package on a Dense: per output channel
    (Linear rows here, Dense columns there)."""
    k = fc.weight.detach().cpu().float().numpy()
    w_absmax = np.max(np.abs(k), axis=1)
    w_scale = np.maximum(w_absmax, 1e-12) / 127.0
    kernel_q = np.clip(np.round(k / w_scale[:, None]), -127, 127).astype(np.int8)
    x_scale = max(float(absmax) * clip_ratio, 1e-12) / 127.0
    dev = fc.weight.device
    return QDense(
        torch.from_numpy(kernel_q).to(dev),
        torch.from_numpy(w_scale.astype(np.float32)).to(dev),
        torch.tensor(x_scale, dtype=torch.float32, device=dev),
        fc.bias.detach().float().clone(),
        fc.weight.dtype,
    )


def _quantize_flat(model: nn.Module, calib: Dict[str, float], clip_ratio: float) -> int:
    """The IR backbones' flat layout: a calibrated folded conv (a conv with
    bias) becomes a `QConv`, the projection `fc` a `QDense`."""
    n = 0
    for name, m in _sites(model).items():
        if name not in calib or calib[name] == 0.0:
            continue
        if isinstance(m, nn.Linear):
            q = quantize_dense(m, calib[name], clip_ratio)
        elif isinstance(m, nn.Conv2d) and m.bias is not None:
            depthwise = m.weight.shape[1] == 1 and m.weight.shape[0] > 1
            if depthwise:
                continue
            q = quantize_site(m, calib[name], clip_ratio)
        else:
            continue  # unfolded, or quantized already
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, q)
        n += 1
    return n


def quantize_model(model: nn.Module, calib: Dict[str, float], clip_ratio: float = 1.0) -> int:
    """Replace, in place, the conv of every calibrated, folded,
    non-depthwise `ConvBN` whose absmax is not 0 by a `QConv` (for an IR
    backbone: every such conv site, and `fc` by a `QDense`).
    `clip_ratio` scales every activation scale below its calibrated
    absmax (`search_clip_ratio`). Returns the number of sites; raises
    ValueError when there is none (an unfolded model, or calibration of
    another model)."""
    n = _quantize_flat(model, calib, clip_ratio) if hasattr(model, "quant_sites") else 0
    for name, m in model.named_modules():
        if not isinstance(m, ConvBN) or name not in calib:
            continue
        conv = m.conv
        if m.bn is not None or not isinstance(conv, nn.Conv2d) or conv.bias is None:
            continue  # unfolded, or quantized already
        depthwise = conv.weight.shape[1] == 1 and conv.weight.shape[0] > 1
        if depthwise or calib[name] == 0.0:
            continue
        m.conv = quantize_site(conv, calib[name], clip_ratio)
        n += 1
    if n == 0:
        raise ValueError(
            "quantize_model: no quantizable ConvBN sites found — did you "
            "fold the BatchNorms first and calibrate the same model?"
        )
    return n


def _outputs(model, x) -> Tuple[np.ndarray, ...]:
    with torch.inference_mode():
        return tuple(t.double().cpu().numpy() for t in model(x))


def _rel_err(out, ref) -> float:
    """Mean per-output relative L2 error."""
    errs = []
    for a, b in zip(out, ref):
        den = float(np.sqrt(np.sum(b * b)))
        errs.append(float(np.sqrt(np.sum((a - b) ** 2))) / max(den, 1e-30))
    return float(np.mean(errs))


def search_clip_ratio(
    model: nn.Module,
    calib: Dict[str, float],
    batches: Iterable[torch.Tensor],
    grid: Sequence[float] = (1.0, 0.95, 0.9, 0.85, 0.8, 0.7, 0.6),
    score_fn: Optional[Callable[[nn.Module], float]] = None,
):
    """Grid-search one global activation clip ratio by end-to-end error:
    per ratio r, a copy of the float `model` quantized at r, scored by the
    mean relative L2 error of its outputs against the float model's on
    `batches`, or by `score_fn(quantized_model)` (lower is better) when
    given. Returns (best_ratio, {ratio: score}); `model` is unchanged."""
    if score_fn is None:
        batches = list(batches)
        if not batches:
            raise ValueError("search_clip_ratio: no batches provided")
        refs = [_outputs(model, x) for x in batches]

        def score_fn(qmodel):
            return float(np.mean([_rel_err(_outputs(qmodel, x), ref) for x, ref in zip(batches, refs)]))

    errs: Dict[float, float] = {}
    for r in grid:
        qmodel = copy.deepcopy(model)
        quantize_model(qmodel, calib, clip_ratio=float(r))
        errs[float(r)] = float(score_fn(qmodel))
    best = min(errs, key=errs.get)
    return best, errs
