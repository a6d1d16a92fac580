"""Weights carried between the JAX package and the port.

`state_dict_from_flax` turns the JAX package's `{"params", "batch_stats"}`
variables, as nested dicts of numpy arrays, into the port's state dict;
`flax_from_state_dict` goes back (so that parameters, gradients and
BatchNorm statistics after a train step can be compared leaf by leaf).
The port's module names mirror the flax paths, so the walk is mechanical:

  conv kernel HWIO (k, k, I, O)    -> weight OIHW   (depthwise (k,k,1,C) -> (C,1,k,k))
  conv1d kernel (k, 1, 1)          -> weight (1, 1, k)
  Dense kernel (in, out)           -> Linear weight (out, in)
  conv / Dense bias                -> bias
  PReLU alpha                      -> alpha
  BatchNorm scale / bias           -> weight / bias
  BatchNorm mean / var             -> running_mean / running_var (+ num_batches_tracked)

An affine-free BatchNorm (the IR backbones' `features_bn`) has statistics
and no parameters on both sides.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BN_PARAMS = {"scale": "weight", "bias": "bias"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 2:  # Dense (I, O) -> Linear (O, I)
        return kernel.T
    if kernel.ndim == 4:  # (H, W, I, O) -> (O, I, H, W)
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 3:  # (W, I, O) -> (O, I, W)
        return kernel.transpose(2, 1, 0)
    raise ValueError(f"unexpected conv kernel rank {kernel.ndim}")


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} (unfolded) -> state dict."""
    stats = variables.get("batch_stats", {})
    bn_paths = {path[:-1] for path, _ in _leaves(stats)}
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables["params"]):
        module, leaf = path[:-1], path[-1]
        if module in bn_paths:
            name = _BN_PARAMS[leaf]
        elif leaf == "kernel":
            name, value = "weight", _conv_weight(value)
        elif leaf in ("bias", "alpha"):
            name = leaf
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[".".join(module + (name,))] = torch.tensor(value, dtype=torch.float32)
    for path, value in _leaves(stats):
        module = path[:-1]
        out[".".join(module + (_BN_STATS[path[-1]],))] = torch.tensor(
            value, dtype=torch.float32
        )
    for module in bn_paths:
        out[".".join(module + ("num_batches_tracked",))] = torch.zeros((), dtype=torch.int64)
    return out


def _conv_kernel(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 2:  # Linear (O, I) -> Dense (I, O)
        return weight.T
    if weight.ndim == 4:  # (O, I, H, W) -> (H, W, I, O)
        return weight.transpose(2, 3, 1, 0)
    if weight.ndim == 3:  # (O, I, W) -> (W, I, O)
        return weight.transpose(2, 1, 0)
    raise ValueError(f"unexpected conv weight rank {weight.ndim}")


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """State dict (or a dict of gradients under the same keys) ->
    {"params": ..., "batch_stats": ...} as nested dicts of float32 numpy
    arrays: the inverse of `state_dict_from_flax`. A module with a
    running_mean is a BatchNorm; `num_batches_tracked` is dropped."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    params: Dict = {}
    stats: Dict = {}
    inverse_bn = {v: k for k, v in {**_BN_PARAMS, **_BN_STATS}.items()}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        array = value.detach().cpu().float().numpy()
        tree = params
        if module in bn_modules:
            tree = stats if leaf in _BN_STATS.values() else params
            name = inverse_bn[leaf]
        elif leaf == "weight":
            name, array = "kernel", _conv_kernel(array)
        elif leaf in ("bias", "alpha"):
            name = leaf
        else:
            raise ValueError(f"unexpected state dict entry {key}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = array
    return {"params": params, "batch_stats": stats}
