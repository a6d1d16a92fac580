"""Portable flat-npz weights, in the JAX package's key layout.

Port of `jabd_tpu/utils/np_ckpt.py`. One .npz holds every parameter and
BatchNorm statistic of a detector under the JAX package's tree paths,
`params['backbone']['layer1_block0']['conv1']['bn']['bias']`,
`batch_stats[...]['mean']` (jax.tree_util.keystr of the variables tree).
The walk between those paths and the port's state dict is
`utils/convert.py`, so a file written by either package loads in the
other; the fixture `tests/fixtures/trained_parity/ckpt_retinaface_r_96.npz`
is one. The reference's counterpart is torch.save of a flat state_dict
(train_mobilenetV3_ecagai.py:547).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax


def _flatten(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}[{str(key)!r}]"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _unflatten(flat: Mapping[str, np.ndarray], prefix: str) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "['"):
            continue
        parts = key[len(prefix) + 2 : -2].split("']['")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_variables_npz(
    path: str, state: Mapping[str, torch.Tensor], params_dtype: Optional[np.dtype] = None
) -> None:
    """Save a state dict as one compressed npz in the JAX package's
    layout. `params_dtype` (e.g. np.float16) stores the parameters in
    that type; BatchNorm statistics stay float32."""
    variables = flax_from_state_dict(state)
    params = variables["params"]
    flat = _flatten(params, "params")
    if params_dtype is not None:
        flat = {k: v.astype(params_dtype) for k, v in flat.items()}
    flat.update(_flatten(variables["batch_stats"], "batch_stats"))
    np.savez_compressed(path, **flat)


def load_variables_npz(path: str, template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Read a save_variables_npz file (either package's) into a state dict
    with `template`'s keys (a model's state_dict()), float32, on the CPU.
    Raises KeyError for an entry the file lacks and ValueError for a shape
    that differs; entries of the file the template lacks are ignored, as in
    the JAX package."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    loaded = state_dict_from_flax(
        {"params": _unflatten(flat, "params"), "batch_stats": _unflatten(flat, "batch_stats")}
    )
    out = {}
    for key, want in template.items():
        if key.endswith("num_batches_tracked"):
            out[key] = want.detach().cpu().clone()
            continue
        if key not in loaded:
            raise KeyError(f"checkpoint is missing {key}")
        if tuple(loaded[key].shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(loaded[key].shape)} != {tuple(want.shape)}")
        out[key] = loaded[key]
    return out
