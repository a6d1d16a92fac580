"""Front half of anchor matching: the CUDA kernel `csrc/matching.cu` for
tensors on the card, the plain version (`ops/matching.py`) for tensors
on the CPU.

Replaces `_match_front` (jabd_tpu/ops/matching_pallas.py), the training
path's one TPU kernel, and the cross-tile argmax after it: one launch per
loss call, grid (P / 1024 tiles, B), for any G (each block walks the GT
rows 256 at a time). Tiles skip the GTs that do not meet their priors'
bounding box, and the last block of each image combines the tiles'
per-GT maxima, so the outputs need no further op.
`match_front.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from jabd_tpu_torch import _build
from jabd_tpu_torch.ops import matching as M

_lock = threading.Lock()
# Per-image arrival counters of the in-launch combine, per (device, stream):
# zero between launches (the last block of each image resets its own), so
# they are allocated once. Launches on two streams at once would race on
# shared counters, hence one set per stream.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_MAX_B = 65535


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("matching")
    lib.jabd_match_front.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.jabd_match_front.restype = ctypes.c_int
    lib.jabd_match_tile.argtypes = []
    lib.jabd_match_tile.restype = ctypes.c_int
    return lib


def match_front(
    truths: torch.Tensor,  # [B, G, 4] float32 corner form, padded
    priors: torch.Tensor,  # [P, 4] float32 cxcywh
    valid: torch.Tensor,  # [B, G] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_truth_overlap [B, P], best_truth_idx [B, P] int64,
    best_prior_idx [B, G] int64), equal to `M.match_front_plain` bit for
    bit. On the card: one kernel launch for any G, plus B * ceil(P / 1024)
    * G int64 words of scratch from the caching allocator (1 MB at B 34,
    G 128, P 29,126; 16 MB at G 2,048). It raises for B above 65,535 (the
    grid's y) and never falls back to the plain version."""
    if truths.device.type == "cpu":
        return M.match_front_plain(truths, priors, valid)
    if truths.device.type != "cuda" or {priors.device, valid.device} != {truths.device}:
        raise ValueError(
            f"truths on {truths.device}, priors on {priors.device}, valid on "
            f"{valid.device}: all must lie on one CUDA device (or on the CPU)"
        )
    if truths.dtype != torch.float32 or priors.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"want float32 truths and priors and bool valid, got {truths.dtype}, "
            f"{priors.dtype}, {valid.dtype}"
        )
    if (
        truths.dim() != 3 or truths.shape[2] != 4 or valid.shape != truths.shape[:2]
        or priors.dim() != 2 or priors.shape[1] != 4
    ):
        raise ValueError(
            f"want truths [B, G, 4], valid [B, G] and priors [P, 4], got "
            f"{tuple(truths.shape)}, {tuple(valid.shape)} and {tuple(priors.shape)}"
        )
    if not (truths.is_contiguous() and priors.is_contiguous() and valid.is_contiguous()):
        raise ValueError("truths, priors and valid must be contiguous")
    if truths.data_ptr() % 16 or priors.data_ptr() % 16:
        raise ValueError("truths and priors must be 16-byte aligned (float4 loads)")
    lib = _library()
    bsz, g = valid.shape
    p = priors.shape[0]
    if not (0 < bsz <= _MAX_B and g > 0 and p > 0):
        raise ValueError(
            f"B = {bsz}, G = {g}, P = {p}: the kernel takes 0 < B <= {_MAX_B}, G > 0, P > 0"
        )
    ntiles = -(-p // lib.jabd_match_tile())
    dev = truths.device
    bt_ov = torch.empty((bsz, p), dtype=torch.float32, device=dev)
    bt_ix = torch.empty((bsz, p), dtype=torch.int64, device=dev)
    bp_ix = torch.empty((bsz, g), dtype=torch.int64, device=dev)
    tile_key = torch.empty((bsz, ntiles, g), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _image_counters(dev, stream)
        err = lib.jabd_match_front(
            truths.data_ptr(), valid.data_ptr(), priors.data_ptr(),
            bt_ov.data_ptr(), bt_ix.data_ptr(), bp_ix.data_ptr(), tile_key.data_ptr(),
            counters.data_ptr(), bsz, g, p, stream,
        )
    if err != 0:
        raise RuntimeError(f"match_front kernel launch failed: cudaError {err}")
    with _lock:
        match_front.launches += 1
    return bt_ov, bt_ix, bp_ix


def _image_counters(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed per-image counters for launches on `stream`."""
    key = (dev.index, stream)
    with _lock:
        if key not in _counters:
            _counters[key] = torch.zeros(_MAX_B, dtype=torch.int32, device=dev)
        return _counters[key]


match_front.launches = 0
