"""Greedy NMS keep masks: the CUDA kernels `csrc/nms.cu` for tensors on
the card, the plain version (`ops/nms.py`) for tensors on the CPU.

Replaces `nms_keep_sorted_pallas_batched` (jabd_tpu/ops/nms_pallas.py),
the serving path's one TPU kernel, and through `nms` its twin `nms_pallas`
(one image, unsorted scores), for any K. Each band of 64-row blocks of the
suppression bitmask (`plan`) launches two kernels on the current stream:
the band's 64x64 tiles of candidate pairs (upper triangle, rows below
n_valid), then a block-serial scan per image that applies the greedy rule
64 boxes at a time and hands its removed set to the next band. Up to
K 12,288 at B 32 there is one band. Keep masks equal the plain version's.
`nms_keep_sorted.launches` counts the calls that launched them, one per
call. While a profiler records, the kernels also count their work into
the recorder's counters (utils/tracing.py): `k1.pairs`, the metric
evaluations of the mask kernel (64 a suppression word it builds), and
`k1.useful_pairs`, those greedy NMS needs (n_valid - 1 - i a kept row
i < n_valid), added by the scan; no kernel more, no wait on the card. The
plain version on the CPU counts its own evaluations (B * K a step, one
step a row below the largest n_valid) and the same useful pairs.

The keep mask is the registered operator `torch.ops.jabd.nms_keep_sorted`
(`torch.library.custom_op`): the CUDA launch for a tensor on the card, the
plain version for one on the CPU, and a fake kernel (an empty bool tensor
shaped like `valid`) for tracing. So `torch.export` (aot.py) records K1 as
one node of the exported graph, and a loaded artifact launches the kernel
through the same path as eager code. Importing this module registers it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from jabd_tpu_torch import _build
from jabd_tpu_torch.ops import nms as N
from jabd_tpu_torch.utils import tracing

_KIND_CODES = {"iou": 0, "diou": 1}
COUNTERS = ("k1.pairs", "k1.useful_pairs")  # the slots `jabd_nms_band` adds to
_lock = threading.Lock()

# Device memory one call may take for scratch, whatever K: the largest
# band's mask plus the removed bitsets and the n_valid counts. `plan` reads
# it at each call.
SCRATCH_BYTES = 1 << 30
WORD = 64  # boxes per mask word = rows per row block
_TILE_BYTES = WORD * 8  # one 64x64 tile of the mask
# The scan's dynamic shared memory (csrc/nms.cu, kScanSmem): two copy
# buffers of `chunk` mask words each (512 bytes a word), then `removed`
# (8 bytes a word). Chunks are CHUNK words, fewer where `removed` leaves
# less room, and at least MIN_CHUNK, which bounds K.
SCAN_SMEM = 227 * 1024 - 1024
CHUNK = 192
MIN_CHUNK = 32
MAX_K = WORD * ((SCAN_SMEM - 2 * MIN_CHUNK * _TILE_BYTES) // 8)  # 1,589,248


class Plan(NamedTuple):
    """How one call of the kernels covers a [B, K] problem."""

    bands: Tuple[Tuple[int, int], ...]  # row-block ranges [r0, r1), in order, covering [0, nb)
    chunk: int  # mask words per bulk copy of the scan
    mask_words: int  # int64 words of the largest band's mask
    removed_words: int  # B * nb
    count_words: int  # int64 words holding the B int32 n_valid counts

    @property
    def scratch_bytes(self) -> int:
        return 8 * (self.mask_words + self.removed_words + self.count_words)


def plan(bsz: int, k: int) -> Plan:
    """Bands and scan chunks for B images of K candidates, from B and K
    alone (no wait on the card for n_valid): each band [r0, r1) takes as
    many row blocks as fit SCRATCH_BYTES beside `removed` and the counts,
    at B * (r1 - r0) * (nb - r0) * 512 bytes, so bands grow as the triangle
    narrows. Raises where the kernels cannot take the problem: K above
    MAX_K, or one row block of the batch over the budget."""
    if k > MAX_K:
        raise ValueError(
            f"NMS of {k} boxes on the card: the scan keeps one removed bit a candidate in shared "
            f"memory beside its copy buffers, K <= {MAX_K}; cut the candidates (pre_nms_topk)"
        )
    budget = SCRATCH_BYTES
    nb = -(-k // WORD)
    removed_words = bsz * nb
    count_words = -(-bsz // 2)
    room = budget - 8 * (removed_words + count_words)
    row_bytes = bsz * nb * _TILE_BYTES  # one row block of the first band, all images
    if room < row_bytes:
        raise ValueError(
            f"NMS of {k} boxes at batch {bsz} on the card: one 64-row block of the suppression "
            f"mask takes {row_bytes} bytes beside {budget - room} of bitsets, over the "
            f"{budget}-byte scratch budget; cut the candidates (pre_nms_topk) or the batch"
        )
    bands, r0, mask_words = [], 0, 0
    while r0 < nb:
        row_words = bsz * (nb - r0) * WORD
        r1 = min(nb, r0 + room // (8 * row_words))
        bands.append((r0, r1))
        mask_words = max(mask_words, (r1 - r0) * row_words)
        r0 = r1
    chunk = min(CHUNK, (SCAN_SMEM - 8 * nb) // (2 * _TILE_BYTES), nb)
    return Plan(tuple(bands), chunk, mask_words, removed_words, count_words)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("nms")
    lib.jabd_nms_band.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jabd_nms_band.restype = ctypes.c_int
    return lib


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, kind: str, beta1: float) -> torch.Tensor:
    """The two kernels on the card; checks what they take and raises on
    anything else."""
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
    pl = plan(bsz, k)
    lib = _library()
    scratch = torch.empty(pl.scratch_bytes // 8, dtype=torch.int64, device=boxes.device)
    work = tracing.device_counts(COUNTERS, boxes.device)
    work = None if work is None else work.data_ptr()
    mask = scratch.data_ptr()
    removed = mask + 8 * pl.mask_words
    counts = removed + 8 * pl.removed_words
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0, r1 in pl.bands:
            err = lib.jabd_nms_band(
                boxes.data_ptr(), valid.data_ptr(), mask, removed, counts, keep.data_ptr(),
                bsz, k, r0, r1, pl.chunk, float(iou_threshold), _KIND_CODES[kind], float(beta1), stream,
                work,
            )
            if err != 0:
                raise RuntimeError(
                    f"nms_keep_sorted kernel launch failed at band {r0}..{r1}: cudaError {err}"
                )
    with _lock:
        nms_keep_sorted.launches += 1
    return keep


def _count_plain(valid: torch.Tensor, keep: torch.Tensor) -> None:
    """The counters of the plain version's call: its metric evaluations
    and the useful pairs, counted as the kernels count theirs."""
    n_valid = valid.sum(1, keepdim=True)
    rows = torch.arange(valid.shape[1])[None]
    useful = torch.where(keep & (rows < n_valid), n_valid - 1 - rows, 0).sum()
    tracing.count(COUNTERS[0], valid.numel() * int(n_valid.max()) if valid.numel() else 0)
    tracing.count(COUNTERS[1], int(useful))


@torch.library.custom_op("jabd::nms_keep_sorted", mutates_args=())
def _keep_op(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, kind: str, beta1: float) -> torch.Tensor:
    if boxes.device.type == "cpu":
        keep = N.nms_keep_sorted(boxes, valid, iou_threshold, kind, beta1)
        if tracing.enabled():
            _count_plain(valid, keep)
        return keep
    return _launch(boxes, valid, iou_threshold, kind, beta1)


@_keep_op.register_fake
def _keep_fake(boxes, valid, iou_threshold, kind, beta1):
    return torch.empty_like(valid, dtype=torch.bool)


def nms_keep_sorted(
    boxes: torch.Tensor,  # [B, K, 4] float32 corner form, sorted by score
    valid: torch.Tensor,  # [B, K] bool
    iou_threshold: float = 0.45,
    kind: str = "iou",
    beta1: float = 1.0,
) -> torch.Tensor:
    """Exact greedy NMS keep masks [B, K] bool (see ops/nms.py), through
    the operator `jabd::nms_keep_sorted`.

    On the card any K up to MAX_K: the call takes at most SCRATCH_BYTES
    (1 GiB) of scratch from the caching allocator (`plan`): one band's
    suppression mask, B * (r1 - r0) * (nb - r0) * 64 int64 words for row
    blocks [r0, r1), nb = ceil(K / 64) (the whole B * nb * nb * 64 when one
    band holds them: 25.6 MB at B 8, K 5000), plus B * nb words of removed
    bits and B counts. It raises where one row block of the batch,
    B * nb * 512 bytes, does not fit (B * K above ~132 M) and for K above
    MAX_K (1,589,248, where the scan's removed bits fill its shared memory;
    P is 272,000 for the largest preset at 1280x1280); it never falls back
    to the plain loop."""
    N.check_kind(kind)
    return torch.ops.jabd.nms_keep_sorted(boxes, valid, float(iou_threshold), kind, float(beta1))


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

    On the card any N up to `nms_keep_sorted`'s limits, as the JAX twin
    takes any N; it never falls back to the plain loop."""
    return N.nms(boxes, scores, iou_threshold, max_out, valid, kind, beta1, keep_fn=nms_keep_sorted)
