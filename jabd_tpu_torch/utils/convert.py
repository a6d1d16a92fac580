"""Weights carried across from the JAX package.

`state_dict_from_flax` turns the JAX package's `{"params", "batch_stats"}`
variables, as nested dicts of numpy arrays, into the port's state dict.
The port's module names mirror the flax paths, so the walk is mechanical:

  conv kernel HWIO (k, k, I, O)    -> weight OIHW   (depthwise (k,k,1,C) -> (C,1,k,k))
  conv1d kernel (k, 1, 1)          -> weight (1, 1, k)
  conv bias                        -> bias
  BatchNorm scale / bias           -> weight / bias
  BatchNorm mean / var             -> running_mean / running_var (+ num_batches_tracked)
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
        elif leaf == "bias":
            name = "bias"
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
