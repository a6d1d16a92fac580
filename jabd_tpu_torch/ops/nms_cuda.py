"""Greedy NMS keep masks: the CUDA kernel `csrc/nms.cu` for tensors on
the card, the plain version (`ops/nms.py`) for tensors on the CPU.

Replaces `nms_keep_sorted_pallas_batched` (jabd_tpu/ops/nms_pallas.py),
the serving path's one TPU kernel, and through `nms` its twin `nms_pallas`
(one image, unsorted scores), for any K up to MAX_K. One launch a call on
the current stream (after a memset of its exchange words): a group of
`width` co-resident blocks per image walks the score-sorted candidates
`chunk` at a time, tests each chunk against the rows already kept (dealt
round-robin over the blocks' shared memory, past that into an overflow
list in scratch) and resolves the chunk's own greedy order; `plan` sizes
it from B, K and the card's SMs. Keep masks equal the plain
version's. `nms_keep_sorted.launches` counts the calls that launched it,
one per call. While a profiler records, the kernel also counts its work
into the recorder's counters (utils/tracing.py): `k1.pairs`, the metric
evaluations it makes (each valid candidate against each kept row before
its chunk, and the chunk's own upper triangle), and `k1.useful_pairs`,
those greedy NMS needs (n_valid - 1 - i a kept row i < n_valid); no
kernel more, no wait on the card. The plain version on the CPU counts its
own evaluations (B * K a step, one step a row below the largest n_valid)
and the same useful pairs.

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
COUNTERS = ("k1.pairs", "k1.useful_pairs")  # the slots `jabd_nms_keep` adds to
_lock = threading.Lock()

# Device memory one call may take for scratch (the exchange words and the
# overflow list), whatever K. `plan` reads it at each call.
SCRATCH_BYTES = 1 << 30
WORD = 64  # rows per resolve block = bits per triangle word
SMS = 132  # an H100's SMs; the wrapper passes the card's own count
CHUNK = 512  # candidates a step, at most; at least WORD
MIN_ROWS = 256  # candidates a block of an image, at least (where there are enough blocks)
STAGE = 256  # overflow entries a block stages in shared memory at once
ENTRY_BYTES = 16  # a kept row in shared memory: its box (float4)
# The kernel's dynamic shared memory (csrc/nms.cu, kSmem): the chunk's
# triangle words (chunk * chunk / 8 bytes, staged by block 0), the boxes of
# the slice (`cap` kept rows) and of the overflow stage, and two chunk
# buffers' boxes and areas (20 bytes a candidate each).
SMEM = 227 * 1024 - 1024
MAX_K = 1_589_248  # the domain of the banded mask-and-scan kernels this one replaced, kept


class Plan(NamedTuple):
    """How one launch of the kernel covers a [B, K] problem."""

    width: int  # blocks an image: block 0 resolves, the others test (one block: both)
    chunk: int  # candidates a step
    cap: int  # kept rows a testing block holds in shared memory
    overflow_words: int  # int32 entries of scratch per image: K - testers * cap, or 0
    bsz: int

    @property
    def testers(self) -> int:
        return max(1, self.width - 1)

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.chunk, self.cap)

    @property
    def exchange_words(self) -> int:
        """int64 exchange words an image: the arrivals, the resolved steps,
        the suppressed bits, the survivors, the triangle words."""
        return 64 + self.chunk * self.chunk // WORD

    @property
    def scratch_bytes(self) -> int:
        return self.bsz * (8 * self.exchange_words + 4 * self.overflow_words)


def smem_bytes(chunk: int, cap: int) -> int:
    return chunk * chunk // 8 + ENTRY_BYTES * (cap + STAGE) + 2 * 20 * chunk


def plan(bsz: int, k: int, sms: int = SMS) -> Plan:
    """The launch for B images of K candidates, from B, K and the card's
    SMs alone (no wait on the card for n_valid): width = min(sms // B,
    ceil(K / MIN_ROWS)) blocks an image (at least 1; B * width fit
    the card at one block an SM, as a cooperative launch needs); chunks of
    512 candidates (the next power of two >= K, at least 64, for fewer);
    the slice each testing block keeps in shared memory as large as SMEM
    leaves; the overflow list for the kept rows past testers * cap, up to
    every candidate. Raises where the kernel cannot take the problem: K above
    MAX_K, or its scratch over SCRATCH_BYTES."""
    if k > MAX_K:
        raise ValueError(
            f"NMS of {k} boxes on the card: the kernel takes K <= {MAX_K}; cut the candidates (pre_nms_topk)"
        )
    chunk = min(CHUNK, max(WORD, 1 << max(k - 1, 0).bit_length()))
    width = max(1, min(sms // max(bsz, 1), -(-k // MIN_ROWS)))
    cap = (SMEM - smem_bytes(chunk, 0)) // ENTRY_BYTES
    pl = Plan(width, chunk, cap, max(0, k - max(1, width - 1) * cap), bsz)
    if pl.scratch_bytes > SCRATCH_BYTES:
        raise ValueError(
            f"NMS of {k} boxes at batch {bsz} on the card: the exchange words and the list of kept rows "
            f"past the kernel's shared memory take {pl.scratch_bytes} bytes, over the {SCRATCH_BYTES}-byte "
            "scratch budget; cut the candidates (pre_nms_topk) or the batch"
        )
    return pl


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("nms")
    lib.jabd_nms_keep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jabd_nms_keep.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, kind: str, beta1: float) -> torch.Tensor:
    """The kernel on the card; checks what it takes and raises on anything
    else."""
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
    if bsz == 0 or k == 0:
        return torch.empty((bsz, k), dtype=torch.bool, device=boxes.device)
    index = boxes.device.index if boxes.device.index is not None else torch.cuda.current_device()
    pl = plan(bsz, k, _sms(index))  # raises before anything is allocated
    keep = torch.empty((bsz, k), dtype=torch.bool, device=boxes.device)
    lib = _library()
    xchg = torch.empty(bsz * pl.exchange_words, dtype=torch.int64, device=boxes.device)  # zeroed by the call
    overflow = torch.empty(bsz * pl.overflow_words, dtype=torch.int32, device=boxes.device) if pl.overflow_words else None
    work = tracing.device_counts(COUNTERS, boxes.device)
    work = None if work is None else work.data_ptr()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jabd_nms_keep(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), None if overflow is None else overflow.data_ptr(),
            xchg.data_ptr(), bsz, k, pl.width, pl.chunk, pl.cap, pl.overflow_words, float(iou_threshold),
            _KIND_CODES[kind], float(beta1), stream, work,
        )
    if err != 0:
        raise RuntimeError(f"nms_keep_sorted kernel launch failed: cudaError {err}")
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

    On the card any K up to MAX_K (1,589,248; P is 272,000 for the largest
    preset at 1280x1280), in one launch (`plan`). Its scratch: the exchange
    words, B * (64 + chunk^2 / 64) int64 (266 KB at B 8), and the list of
    kept rows past the blocks' shared memory, B * (K - testers * cap) int32
    where that is positive (none at B 8, K 67,200); it raises where they
    would pass SCRATCH_BYTES (1 GiB) and for K above MAX_K, and never falls
    back to the plain loop."""
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
