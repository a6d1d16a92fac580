"""Spatial partitioning: one image's height sharded over a local mesh.

Port of the JAX package's spatial serving mode (`jabd_tpu/predict.py::
_spatial_detect_fn`). There a sharding constraint puts the image height on
the mesh and GSPMD inserts the convolutions' halo exchanges and the gathers
that the global-context ops need. PyTorch has no GSPMD (DTensor shards a
convolution only along its last dimension, and refuses stride > 1 with
padding), so this module writes them, in one process over the entries of a
local mesh (`parallel/mesh.py::make_mesh`; an entry may repeat, so
`[cuda:0, cuda:0]` puts two shards on one card).

`ShardedRows` holds an NCHW tensor as row blocks: block i holds the global
rows [bounds[i], bounds[i + 1]) on mesh entry i (`shard_rows`,
`gather_rows`). It is a tensor subclass whose `__torch_function__` runs the
detector's modules unchanged, under a closed set of rules:

  * pointwise ops run per block. An operand without the row axis (a
    [B, C, 1, 1] gate, a scalar) goes to every block; a full map (a
    gathered level) is cut to each block's rows;
  * a conv or a max pool (`stencil`) gives each block the input rows its
    output rows read: for output rows [o0, o1) with kernel k, stride s,
    padding p and dilation d, the rows [o0*s - p, (o1 - 1)*s - p + d(k - 1)].
    The rows a block does not hold come from its neighbours (`.to(device)`;
    on one card a slice), and the weights are the block's device's copy
    (`partition_model`). Outside the image the window takes the op's own
    padding value, zero for a conv and -inf for a max pool;
  * a mean or sum over the rows adds per-block partial sums over the
    blocks, on mesh.devices[0] (so `_spatial_stdv` stays two-pass: the
    global mean first, then the mean of squared deviations from it);
  * cat, stack, unbind and indexing off the row axis and pixel shuffle run
    per block; a slice of the row axis trims the blocks it reaches;
  * a resize gathers the rows, computes once on mesh.devices[0] and shards
    the result again (bicubic taps cross block edges);
  * any other op raises, naming it: nothing gathers silently.

`partition_model` copies the model's parameters and buffers once to every
further device of the mesh; a rule hands each block the copy on its own
device, so no weight moves during a forward, and a parameter with no copy
raises. It also gives three modules rules of their own (it swaps their
class, as `models/layers.py::convert_sync_batchnorm` does): `NLM` keeps its
queries sharded and gathers only its key and value maps (ch channels) for
the PSP pooling; `PredictionHead` gathers each level's head map in row
order before the NHWC flatten, so rows follow ops/anchors.py; `QConv`
quantizes per block and takes a conv's halo, exact in int32 as on one
device.

Deep levels: a stencil keeps its output sharded only while every block
starts on a multiple of its stride, keeps at least one output row, and
reads no further than its two neighbours. When a level no longer allows
that (64 rows over 8 blocks gives 1 row a block at stride 8), its input is
gathered onto mesh.devices[0] and the level goes on there as plain
tensors, replicated, as GSPMD does when a dimension no longer splits.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from jabd_tpu_torch.models import layers as L
from jabd_tpu_torch.models import quantize as Q
from jabd_tpu_torch.parallel import mesh as M

Tensor = torch.Tensor


class ShardedRows(Tensor):
    """Row blocks of an NCHW tensor (see the module note). `parts[i]` is
    block i on `devices[i]`; `hdim` is the row axis (it moves under stack
    and indexing)."""

    @staticmethod
    def __new__(cls, parts: Sequence[Tensor], bounds: Sequence[int], hdim: int, devices: Sequence[torch.device]):
        shape = list(parts[0].shape)
        shape[hdim] = bounds[-1]
        out = Tensor._make_wrapper_subclass(cls, shape, dtype=parts[0].dtype, device=parts[0].device)
        out.parts, out.bounds, out.hdim, out.devices = list(parts), tuple(bounds), hdim, list(devices)
        return out

    def __repr__(self) -> str:
        return f"ShardedRows(shape={tuple(self.shape)}, dtype={self.dtype}, bounds={self.bounds}, hdim={self.hdim})"

    def map(self, fn: Callable[[Tensor], Tensor], hdim: Optional[int] = None, bounds=None) -> "ShardedRows":
        """fn on every block."""
        return ShardedRows([fn(p) for p in self.parts], bounds or self.bounds,
                           self.hdim if hdim is None else hdim, self.devices)

    def spans(self):
        return zip(self.parts, self.bounds, self.bounds[1:])

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"spatial partitioning has no rule for {func}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_meta(func):
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        rule = _RULES.get(func)
        if rule is None:
            name = getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))
            raise NotImplementedError(
                f"spatial partitioning has no rule for {name}: the op would need the whole height "
                f"(add a rule to jabd_tpu_torch/parallel/spatial.py, or gather_rows first)"
            )
        return rule(func, args, kwargs)


_META_PROPERTIES = {"shape", "dtype", "device", "ndim", "layout", "requires_grad", "is_cuda", "is_sparse",
                    "is_quantized", "is_meta", "is_nested", "is_mkldnn"}
_META_METHODS = {Tensor.dim, Tensor.size, Tensor.numel, Tensor.is_floating_point, Tensor.is_complex,
                 Tensor.element_size, Tensor.__len__}


def _is_meta(func) -> bool:
    """A question about the global tensor's metadata, which the wrapper
    answers."""
    if getattr(func, "__name__", None) == "__get__":
        return getattr(getattr(func, "__self__", None), "__name__", None) in _META_PROPERTIES
    return func in _META_METHODS


# ---------------------------------------------------------------------------
# Sharding and gathering
# ---------------------------------------------------------------------------


def shard_rows(x: Tensor, devices: Sequence) -> ShardedRows:
    """NCHW `x` as equal row blocks, block i on devices[i]. The height must
    divide the number of devices (the JAX package's ValueError)."""
    devices = [torch.device(d) for d in devices]
    h, n = x.shape[2], len(devices)
    if h % n:
        raise ValueError(f"input height {h} must divide the serving mesh size {n} for spatial partitioning")
    bounds = [i * h // n for i in range(n + 1)]
    return ShardedRows([x[:, :, a:b].to(d) for d, a, b in zip(devices, bounds, bounds[1:])], bounds, 2, devices)


def gather_rows(x: Tensor) -> Tensor:
    """The whole tensor, its blocks in row order on devices[0] (a plain
    tensor is returned as it is)."""
    if not isinstance(x, ShardedRows):
        return x
    dev = x.devices[0]
    return torch.cat([p.to(dev) for p in x.parts], dim=x.hdim)


# A partitioned model's parameters and buffers -> {device: their copy}, and
# its modules -> {device: their copy}, for each further device of its mesh
# (`partition_model`); an entry goes with its model.
_COPIES = WeakTensorKeyDictionary()
_MODULE_COPIES = weakref.WeakKeyDictionary()


def _to(t: Optional[Tensor], device: torch.device) -> Optional[Tensor]:
    """`t` as a block on `device` sees it: itself there; a partitioned
    model's weight or buffer, its copy made once by `partition_model`;
    anything else (halo rows, a gathered map, a gate) moved."""
    if t is None or t.device == device:
        return t
    copies = _COPIES.get(t)
    if copies is not None:
        return copies[device]
    if isinstance(t, torch.nn.Parameter):
        raise RuntimeError(f"spatial partitioning: a parameter on {t.device} has no copy on {device} "
                           f"(partition_model(model, mesh devices) copies them once)")
    return t.to(device)


def _module_on(m: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`m`'s copy on `device` (`m` itself on its own device)."""
    return _MODULE_COPIES.get(m, {}).get(device, m)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def _layout(args, kwargs) -> ShardedRows:
    """The one row layout of the sharded operands (nested in lists too)."""
    found = []

    def walk(a):
        if isinstance(a, ShardedRows):
            found.append(a)
        elif isinstance(a, (list, tuple)):
            for v in a:
                walk(v)

    walk(list(args) + list(kwargs.values()))
    ref = found[0]
    for x in found[1:]:
        if x.bounds != ref.bounds or x.dim() - x.hdim != ref.dim() - ref.hdim:
            raise ValueError(f"spatial partitioning: row layouts differ ({ref!r} and {x!r})")
    return ref


def _block_arg(a, i: int, ref: ShardedRows, out_ndim: int):
    """Operand `a` as block i of `ref`'s layout sees it: its own block, a
    broadcast operand moved to the block's device, or its rows of a full
    map."""
    if isinstance(a, ShardedRows):
        return a.parts[i]
    if isinstance(a, (list, tuple)):
        return type(a)(_block_arg(v, i, ref, out_ndim) for v in a)
    if not isinstance(a, Tensor):
        return a
    dev = ref.parts[i].device
    j = ref.hdim + (out_ndim - ref.dim()) - (out_ndim - a.dim())
    if j < 0 or a.shape[j] == 1:
        return _to(a, dev)
    if a.shape[j] == ref.bounds[-1]:  # a gathered map meeting a sharded one: cut to the block's rows
        lo, hi = ref.bounds[i], ref.bounds[i + 1]
        return a.narrow(j, lo, hi - lo).to(dev)
    raise ValueError(f"spatial partitioning: operand of shape {tuple(a.shape)} does not broadcast over {ref!r}")


def _per_block(func, args, kwargs, hdim_shift: int = 0, bounds=None):
    ref = _layout(args, kwargs)
    out_ndim = max([ref.dim()] + [a.dim() for a in args if isinstance(a, Tensor) and not isinstance(a, ShardedRows)])
    parts = []
    for i in range(len(ref.parts)):
        parts.append(func(*(_block_arg(a, i, ref, out_ndim) for a in args),
                          **{k: _block_arg(v, i, ref, out_ndim) for k, v in kwargs.items()}))
    hdim = ref.hdim + (out_ndim - ref.dim()) + hdim_shift
    return ShardedRows(parts, bounds or ref.bounds, hdim, ref.devices)


def _pointwise(func, args, kwargs):
    return _per_block(func, args, kwargs)


def _to_dtype(func, args, kwargs):
    if "device" in kwargs or any(isinstance(a, (torch.device, str, Tensor)) for a in args[1:]):
        raise NotImplementedError("spatial partitioning: a sharded tensor changes dtype only, not device")
    return _per_block(func, args, kwargs)


def _softmax(func, args, kwargs):
    x = args[0]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if dim is None or _norm(dim, x.dim()) == x.hdim:
        raise NotImplementedError("spatial partitioning: softmax over the row axis")
    return _per_block(func, args, kwargs)


def _batch_norm(func, args, kwargs):
    training = kwargs.get("training", args[5] if len(args) > 5 else False)
    if training:
        raise NotImplementedError("spatial partitioning serves: a training-mode BatchNorm needs the whole batch")
    return _per_block(func, args, kwargs)


def _reduce(func, args, kwargs):
    """mean / sum. Over the row axis: per-block partial sums in float32 (at
    least), added on devices[0]; the mean divides by the global count."""
    x = args[0]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    keepdim = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
    if "dtype" in kwargs:
        raise NotImplementedError("spatial partitioning: a reduction with dtype=")
    dims = tuple(range(x.dim())) if dim is None else tuple(_norm(d, x.dim()) for d in
                                                          (dim if isinstance(dim, (tuple, list)) else (dim,)))
    if x.hdim not in dims:
        shift = -sum(1 for d in dims if d < x.hdim) if not keepdim else 0
        return _per_block(lambda t: func(t, dims, keepdim), (x,), {}, hdim_shift=shift)
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.devices[0]
    total = None
    for p in x.parts:
        s = p.sum(dim=dims, keepdim=True, dtype=acc).to(dev)
        total = s if total is None else total + s
    if func in (Tensor.mean, torch.mean):
        count = 1
        for d in dims:
            count *= x.shape[d]
        total = total / count
    if not keepdim:
        total = total.squeeze(dims)
    return total.to(x.dtype)


def _joined(func, args, kwargs, stack: bool):
    """cat / stack per block, off the row axis; a full map among the
    tensors (a branch that ran gathered) is cut to each block's rows."""
    tensors = args[0]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
    ref = _layout(args, kwargs)
    dim = _norm(dim, ref.dim() + stack)
    if not stack and dim == ref.hdim:
        raise NotImplementedError("spatial partitioning: cat along the row axis")
    parts = [func([_block_arg(t, i, ref, ref.dim()) for t in tensors], dim) for i in range(len(ref.parts))]
    return ShardedRows(parts, ref.bounds, ref.hdim + (stack and dim <= ref.hdim), ref.devices)


def _cat(func, args, kwargs):
    return _joined(func, args, kwargs, stack=False)


def _stack(func, args, kwargs):
    return _joined(func, args, kwargs, stack=True)


def _unbind(func, args, kwargs):
    x = args[0]
    dim = _norm(kwargs.get("dim", args[1] if len(args) > 1 else 0), x.dim())
    if dim == x.hdim:
        raise NotImplementedError("spatial partitioning: unbind of the row axis")
    pieces = [func(p, dim) for p in x.parts]
    hdim = x.hdim - (dim < x.hdim)
    return tuple(ShardedRows([blk[j] for blk in pieces], x.bounds, hdim, x.devices) for j in range(len(pieces[0])))


def _getitem(func, args, kwargs):
    """x[idx] with ints and slices; a slice of the row axis trims the
    blocks it reaches (PixelShuffleUp's crop trims the last one)."""
    x, idx = args
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not all(isinstance(i, (int, slice)) for i in idx) or len(idx) > x.dim():
        raise NotImplementedError(f"spatial partitioning: indexing with {idx!r}")
    hdim = x.hdim - sum(isinstance(i, int) for i in idx[: x.hdim])
    if len(idx) <= x.hdim:
        return x.map(lambda p: p[idx], hdim=hdim)
    rows = idx[x.hdim]
    if isinstance(rows, int):
        raise NotImplementedError("spatial partitioning: an integer index on the row axis")
    start, stop, step = rows.indices(x.bounds[-1])
    if step != 1:
        raise NotImplementedError("spatial partitioning: a strided slice of the row axis")
    parts, bounds = [], [0]
    for p, lo, hi in x.spans():
        a, b = max(lo, start), min(hi, stop)
        if a >= b:
            raise NotImplementedError(f"spatial partitioning: rows {start}:{stop} leave a block empty")
        local = idx[: x.hdim] + (slice(a - lo, b - lo),) + idx[x.hdim + 1:]
        parts.append(p[local])
        bounds.append(bounds[-1] + b - a)
    return ShardedRows(parts, bounds, hdim, x.devices)


def _pixel_shuffle(func, args, kwargs):
    x = args[0]
    r = kwargs.get("upscale_factor", args[1] if len(args) > 1 else None)
    if x.hdim != x.dim() - 2:
        raise NotImplementedError("spatial partitioning: pixel shuffle with the rows off dimension -2")
    # Each input row gives r output rows: the blocks stay in place.
    return x.map(lambda p: func(p, r), bounds=[b * r for b in x.bounds])


def _interpolate(func, args, kwargs):
    """A resize reads across block edges (bicubic, align_corners): gather,
    resize once on devices[0], shard the result again when the mesh divides
    its height (else it stays whole there)."""
    x = args[0]
    if x.hdim != 2:
        raise NotImplementedError(f"spatial partitioning: a resize needs NCHW rows, got {x!r}")
    out = func(gather_rows(x), *args[1:], **kwargs)
    if out.shape[2] % len(x.parts):
        return out
    return shard_rows(out, x.devices)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _bind(args, kwargs, names, defaults):
    got = dict(zip(names, args))
    got.update(kwargs)
    return [got.get(n, d) for n, d in zip(names, defaults)]


def stencil(x: ShardedRows, k: int, s: int, p: int, d: int, value: float,
            fn: Callable[[Tensor, int], Tensor]) -> Tensor:
    """A windowed op along the rows of `x` (kernel k, stride s, padding p,
    dilation d). `fn(t, ph)` computes the op on a plain NCHW tensor with ph
    rows of padding at its top and bottom. Each block gets the window of
    input rows its output rows read, with `value` rows outside the image,
    and computes with ph = 0; the output stays sharded. When the layout does
    not allow that (see the module note), the input is gathered and the op
    runs once on devices[0] with ph = p: a plain tensor."""
    if x.hdim != 2 or x.dim() != 4:
        raise NotImplementedError(f"spatial partitioning: a windowed op needs NCHW rows, got {x!r}")
    h, n, ext = x.bounds[-1], len(x.parts), d * (k - 1)
    ho = (h + 2 * p - ext - 1) // s + 1
    out = [b // s for b in x.bounds[:-1]] + [ho]
    lo = [o * s - p for o in out[:-1]]
    hi = [(o - 1) * s - p + ext + 1 for o in out[1:]]
    fits = (all(b % s == 0 for b in x.bounds[:-1]) and all(a < b for a, b in zip(out, out[1:]))
            and all(lo[i] >= x.bounds[max(i - 1, 0)] or i == 0 for i in range(n))
            and all(hi[i] <= x.bounds[min(i + 2, n)] or i == n - 1 for i in range(n)))
    if not fits:
        # The level no longer splits: gather it and run the rest of it
        # replicated on devices[0], as GSPMD does.
        return fn(gather_rows(x), p)
    parts = []
    for i, dev in enumerate(t.device for t in x.parts):
        a, b = max(lo[i], 0), min(hi[i], h)
        rows = [t.narrow(2, max(a, t0) - t0, min(b, t1) - max(a, t0)).to(dev)
                for t, t0, t1 in x.spans() if max(a, t0) < min(b, t1)]
        win = rows[0] if len(rows) == 1 else torch.cat(rows, dim=2)
        if a - lo[i] or hi[i] - b:  # the image's own top / bottom edge
            win = F.pad(win, (0, 0, a - lo[i], hi[i] - b), value=value)
        parts.append(fn(win, 0))
    return ShardedRows(parts, out, 2, x.devices)


def _conv2d(func, args, kwargs):
    x, weight, bias, stride, padding, dilation, groups = _bind(
        args, kwargs, ("input", "weight", "bias", "stride", "padding", "dilation", "groups"),
        (None, None, None, 1, 0, 1, 1))
    if isinstance(padding, str):
        raise NotImplementedError(f"spatial partitioning: conv padding {padding!r}")
    (sh, _), (ph, pw), (dh, _) = _pair(stride), _pair(padding), _pair(dilation)

    def conv(t, top):
        return func(t, _to(weight, t.device), _to(bias, t.device), stride, (top, pw), dilation, groups)

    return stencil(x, weight.shape[2], sh, ph, dh, 0.0, conv)


def _max_pool2d(func, args, kwargs):
    x, kernel, stride, padding, dilation, ceil_mode, return_indices = _bind(
        args, kwargs, ("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode", "return_indices"),
        (None, None, None, 0, 1, False, False))
    if ceil_mode or return_indices:
        raise NotImplementedError("spatial partitioning: max pool with ceil_mode or return_indices")
    (kh, _), (ph, pw), (dh, _) = _pair(kernel), _pair(padding), _pair(dilation)
    stride = _pair(stride if stride else kernel)

    def pool(t, top):
        return func(t, kernel, stride, (top, pw), dilation)

    return stencil(x, kh, stride[0], ph, dh, float("-inf"), pool)


def _methods(*names):
    out = []
    for n in names:
        for owner in (Tensor, torch):
            f = getattr(owner, n, None)
            if f is not None:
                out.append(f)
    return out


_RULES = {}
for _f in _methods("add", "sub", "mul", "div", "pow", "__pow__", "sigmoid", "round", "clamp", "float") + [
        F.relu, F.relu6, F.leaky_relu]:
    _RULES[_f] = _pointwise
_RULES.update({f: _softmax for f in _methods("softmax") + [F.softmax]})
_RULES.update({f: _reduce for f in _methods("mean", "sum")})
_RULES.update({f: _unbind for f in _methods("unbind")})
_RULES.update({
    Tensor.to: _to_dtype,
    F.batch_norm: _batch_norm,
    torch.cat: _cat,
    torch.stack: _stack,
    Tensor.__getitem__: _getitem,
    torch.pixel_shuffle: _pixel_shuffle,
    F.interpolate: _interpolate,
    torch.conv2d: _conv2d,
    F.max_pool2d: _max_pool2d,
})


# ---------------------------------------------------------------------------
# Module rules
# ---------------------------------------------------------------------------


class SpatialNLM(L.NLM):
    """NLM over row blocks: the PSP pooling reads the whole map, so the key
    and value maps (ch channels, not the module's input width) are
    gathered and pooled once; each block attends its own queries to them."""

    def forward(self, x):
        if not isinstance(x, ShardedRows):
            return super().forward(x)
        k = L.psp(gather_rows(self.f_key(x)), self.psp_sizes)
        v = L.psp(gather_rows(self.f_value(x)), self.psp_sizes)
        return x.map(lambda part: _module_on(self, part.device).attend(part, k.to(part.device), v.to(part.device)))


class SpatialPredictionHead(L.PredictionHead):
    """A head over row blocks: the 1x1 conv per block, then the map gathered
    in row order before the NHWC flatten, so the rows follow the anchors."""

    def forward(self, x):
        if not isinstance(x, ShardedRows):
            return super().forward(x)
        y = gather_rows(self.conv1x1(x))
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.out_dim)


class SpatialQConv(Q.QConv):
    """The int8 conv over row blocks: quantization per block (pointwise),
    then the int32 conv on each block's window, padded with the quantized
    zero, so the sums are the single device's exactly."""

    def forward(self, x):
        if not isinstance(x, ShardedRows):
            return super().forward(x)
        y = stencil(self.quantize_input(x), self.kernel_q.shape[2], self.stride, self.padding, 1, 0,
                    lambda t, top: _module_on(self, t.device).int_conv(t, (top, self.padding)))
        return self.dequantize(y)


_MODULE_RULES = {L.NLM: SpatialNLM, L.PredictionHead: SpatialPredictionHead, Q.QConv: SpatialQConv}


def partition_model(model: torch.nn.Module, devices: Sequence) -> torch.nn.Module:
    """Ready `model` (on devices[0]) to run over row blocks on `devices`, in
    place: its NLM, PredictionHead and QConv modules get their spatial rules
    (the class is swapped: names, state and plain inputs are unchanged), and
    one copy of the model goes to each further distinct device, whose
    blocks compute with it. Run it again after `quantize_model`."""
    for m in model.modules():
        cls = _MODULE_RULES.get(type(m))
        if cls is not None:
            m.__class__ = cls
    home = next(model.parameters()).device
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    for t in tensors.values():
        _COPIES.pop(t, None)
    for m in model.modules():
        _MODULE_COPIES.pop(m, None)
    others = [d for d in dict.fromkeys(torch.empty(0, device=d).device for d in devices) if d != home]
    for dev, twin in zip(others, M.replicate_tree(model, M.Mesh(others))):
        twin_tensors = dict(twin.named_parameters())
        twin_tensors.update(twin.named_buffers())
        for name, t in tensors.items():
            _COPIES.setdefault(t, {})[dev] = twin_tensors[name]
        for m, m2 in zip(model.modules(), twin.modules()):
            _MODULE_COPIES.setdefault(m, {})[dev] = m2
    return model

