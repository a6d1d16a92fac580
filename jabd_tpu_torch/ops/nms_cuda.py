"""Greedy NMS keep masks: the CUDA kernels `csrc/nms.cu` for tensors on
the card, the plain version (`ops/nms.py`) for tensors on the CPU.

Replaces `nms_keep_sorted_pallas_batched` (jabd_tpu/ops/nms_pallas.py),
the serving path's one TPU kernel, and through `nms` its twin `nms_pallas`
(one image, unsorted scores). One call launches two kernels on the
current stream: a suppression bitmask over 64x64 tiles of candidate pairs
(the upper triangle, rows below n_valid), then a block-serial scan per
image that applies the greedy rule 64 boxes at a time. Keep masks equal
the plain version's. `nms_keep_sorted.launches` counts the calls that
launched them, one per call.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from jabd_tpu_torch import _build
from jabd_tpu_torch.ops import nms as N

_KIND_CODES = {"iou": 0, "diou": 1}
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("nms")
    lib.jabd_nms_keep_sorted.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.jabd_nms_keep_sorted.restype = ctypes.c_int
    lib.jabd_nms_max_k.argtypes = []
    lib.jabd_nms_max_k.restype = ctypes.c_int
    return lib


def nms_keep_sorted(
    boxes: torch.Tensor,  # [B, K, 4] float32 corner form, sorted by score
    valid: torch.Tensor,  # [B, K] bool
    iou_threshold: float = 0.45,
    kind: str = "iou",
    beta1: float = 1.0,
) -> torch.Tensor:
    """Exact greedy NMS keep masks [B, K] bool (see ops/nms.py).

    On the card K may be at most `jabd_nms_max_k()` (12,288). The call
    allocates a scratch bitmask of B * nb * nb * 64 int64 words, nb =
    ceil(K / 64), from the caching allocator: 25.6 MB at B 8, K 5000."""
    N.check_kind(kind)
    if boxes.device.type == "cpu":
        return N.nms_keep_sorted(boxes, valid, iou_threshold, kind, beta1)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(
            f"boxes on {boxes.device} and valid on {valid.device}: both "
            "must lie on one CUDA device (or on the CPU)"
        )
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"want float32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"want boxes [B, K, 4] and valid [B, K], got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    bsz, k = valid.shape
    keep = torch.empty((bsz, k), dtype=torch.bool, device=boxes.device)
    if bsz == 0 or k == 0:
        return keep
    lib = _library()
    if k > lib.jabd_nms_max_k():
        raise ValueError(
            f"NMS of {k} boxes on the card: the kernel takes at most {lib.jabd_nms_max_k()}; "
            "cut the candidates first (ops/nms.py::topk_candidates)"
        )
    nb = -(-k // 64)
    mask = torch.empty((bsz, nb, nb, 64), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jabd_nms_keep_sorted(
            boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            bsz, k, float(iou_threshold), _KIND_CODES[kind], float(beta1),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_keep_sorted kernel launch failed: cudaError {err}")
    with _lock:
        nms_keep_sorted.launches += 1
    return keep


nms_keep_sorted.launches = 0


def nms(
    boxes: torch.Tensor,  # [N, 4]
    scores: torch.Tensor,  # [N]
    iou_threshold: float = 0.45,
    max_out: int = 750,
    valid: Optional[torch.Tensor] = None,
    kind: str = "iou",
    beta1: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of `nms_pallas` (jabd_tpu/ops/nms_pallas.py): a stable sort of
    the masked scores, the keep mask of the sorted boxes as [1, N] through
    `nms_keep_sorted` (the kernel on the card, the plain loop on the CPU),
    then the compaction to ([max_out] indices into the input, valid).

    On the card N may be at most `jabd_nms_max_k()` (12,288); a larger N
    raises, where the JAX twin has no cap. It never falls back to the
    plain loop."""
    return N.nms(boxes, scores, iou_threshold, max_out, valid, kind, beta1, keep_fn=nms_keep_sorted)
