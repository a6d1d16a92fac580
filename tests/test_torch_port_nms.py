"""PyTorch port, greedy NMS: the plain version (the oracle of the CUDA
kernel) gives keep masks EQUAL to the JAX package's XLA NMS and to its
Pallas kernel in interpret mode; the wrapper's CPU dispatch; and a torch
emulation of the CUDA kernels' algorithm (suppression bitmask, 64-row
block scan) gives the plain version's keep masks. The CUDA kernels
themselves are held against the plain version on the card by
`chip_smoke.py` (these tests import jax, which that machine lacks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.ops import nms as JN
from jabd_tpu.ops import nms_pallas as JP
from jabd_tpu_torch.ops import nms as TN
from jabd_tpu_torch.ops import nms_cuda
from tests.conftest import random_boxes


def _batch(rng, bsz, k, n_valid, ties=False, zero_area=False, duplicates=False):
    boxes = np.stack([random_boxes(rng, k) for _ in range(bsz)])
    if ties:  # grid boxes: many exactly equal metrics
        xy = rng.integers(0, 12, (bsz, k, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + 4.0], -1)
    if zero_area:
        flat = rng.random((bsz, k)) < 0.4
        boxes[..., 2] = np.where(flat, boxes[..., 0], boxes[..., 2])
        boxes[:, : k // 5] = boxes[:, :1]  # identical degenerate boxes: union 0
    if duplicates:
        boxes = boxes[:, rng.integers(0, 7, k)]
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return boxes.astype(np.float32), valid


def _jax_xla(boxes, valid, thr, kind):
    fn = jax.vmap(lambda b, v: JN.nms_keep_sorted(b, v, thr, kind=kind))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(valid)))


def _jax_pallas(boxes, valid, thr, kind):
    return np.asarray(
        JP.nms_keep_sorted_pallas_batched(
            jnp.asarray(boxes), jnp.asarray(valid), thr, kind=kind, interpret=True
        )
    )


def _plain(boxes, valid, thr, kind):
    return TN.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), thr, kind).numpy()


CASES = {
    "random": dict(bsz=3, k=200, n_valid=[200, 150, 0]),
    "k_not_multiple_of_128": dict(bsz=2, k=333, n_valid=[333, 301]),
    "invalid_suffix": dict(bsz=2, k=160, n_valid=[37, 1]),
    "ties": dict(bsz=2, k=150, n_valid=[150, 120], ties=True),
    "zero_area": dict(bsz=2, k=140, n_valid=[140, 99], zero_area=True),
    "duplicates": dict(bsz=2, k=130, n_valid=[130, 64], duplicates=True),
}


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_xla_nms(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    for thr in (0.3, 0.45):
        want = _jax_xla(boxes, valid, thr, kind)
        np.testing.assert_array_equal(_plain(boxes, valid, thr, kind), want)


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", ["random", "k_not_multiple_of_128", "ties", "zero_area"])
def test_plain_equals_pallas_interpret(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    want = _jax_pallas(boxes, valid, 0.3, kind)
    np.testing.assert_array_equal(_plain(boxes, valid, 0.3, kind), want)


def test_identical_boxes_keep_first():
    boxes = np.tile(np.asarray([[0.1, 0.1, 0.4, 0.4]], np.float32), (1, 5, 1))
    keep = _plain(boxes, np.ones((1, 5), bool), 0.45, "iou")
    np.testing.assert_array_equal(keep, [[True, False, False, False, False]])


def test_unknown_kind_raises(rng):
    boxes, valid = _batch(rng, 1, 8, [8])
    with pytest.raises(ValueError, match="unknown nms kind"):
        TN.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3, "DIoU")
    with pytest.raises(ValueError, match="unknown nms kind"):
        nms_cuda.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3, "giou")


def test_wrapper_takes_the_plain_version_on_cpu(rng):
    boxes, valid = _batch(rng, 2, 100, [100, 50])
    before = nms_cuda.nms_keep_sorted.launches
    got = nms_cuda.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3)
    np.testing.assert_array_equal(got.numpy(), _plain(boxes, valid, 0.3, "iou"))
    assert nms_cuda.nms_keep_sorted.launches == before  # no kernel ran


_WORD = 64
_U64 = (1 << 64) - 1


def _k1_emulation(boxes, valid, thr, kind, beta1=1.0, seed=0):
    """`csrc/nms.cu`'s algorithm on the CPU. The mask kernel: words
    mask[b, i, cb] (bit c: j = 64 cb + c > i and metric(i, j) > thr),
    written only where the kernel writes them (rows i < n_valid, column
    blocks cb >= i // 64; zeros for an invalid row or a column block with
    no valid box; pairs with inter == 0 skipped when thr >= 0); every other
    word is garbage, as torch.empty leaves it. Then the scan: per row block
    r < ceil(n_valid / 64), its survivors as the fixed point of "the
    candidates minus what the survivors suppress" over the diagonal words,
    iterated from all candidates, then the surviving rows' later words ORed
    into `removed`; keep = ~removed."""
    boxes_t, valid_t = torch.from_numpy(boxes), torch.from_numpy(valid)
    bsz, k = valid.shape
    nb = -(-k // _WORD)
    garbage = np.random.default_rng(seed).integers(-(2**63), 2**63 - 1, (bsz, k, nb), dtype=np.int64)
    mask = torch.from_numpy(garbage)
    areas = (boxes_t[..., 2] - boxes_t[..., 0]) * (boxes_t[..., 3] - boxes_t[..., 1])
    bits = torch.bitwise_left_shift(torch.ones(_WORD, dtype=torch.int64), torch.arange(_WORD))
    cols = torch.arange(k)
    keep = np.zeros((bsz, k), bool)
    for b in range(bsz):
        n = int(valid[b].sum())
        if n:
            rows = boxes_t[b, :n]
            metric = TN._metric(rows, boxes_t[b].expand(n, k, 4), areas[b].expand(n, k), kind, beta1)
            sup = (metric > thr) & (cols[None] > torch.arange(n)[:, None])
            if thr >= 0:  # the kernel's early-out: a disjoint pair never suppresses
                x = torch.clamp(torch.minimum(rows[:, None, 2], boxes_t[b, None, :, 2])
                                - torch.maximum(rows[:, None, 0], boxes_t[b, None, :, 0]), min=0.0)
                y = torch.clamp(torch.minimum(rows[:, None, 3], boxes_t[b, None, :, 3])
                                - torch.maximum(rows[:, None, 1], boxes_t[b, None, :, 1]), min=0.0)
                sup &= x * y != 0
            sup &= valid_t[b, :n, None]  # an invalid row's word is zero
            for cb in range(nb):
                lo, hi = cb * _WORD, min(k, (cb + 1) * _WORD)
                words = (sup[:, lo:hi].long() * bits[: hi - lo]).sum(1)  # distinct bits: sum == OR
                if not valid[b, lo:hi].any():
                    words = torch.zeros_like(words)
                upper = torch.arange(n) // _WORD <= cb
                mask[b, :n][upper, cb] = words[upper]
        words = mask[b].numpy()
        removed = [_U64] * nb
        for w in range(nb):
            for c in range(_WORD):
                if w * _WORD + c < k and valid[b, w * _WORD + c]:
                    removed[w] &= ~(1 << c)
        for r in range(-(-n // _WORD)):
            live = min(_WORD, n - r * _WORD)
            alive = ~removed[r] & ((1 << live) - 1)
            diag = [int(words[r * _WORD + t, r]) & _U64 for t in range(live)]
            kept = alive
            while True:  # survivors = alive minus what the survivors suppress
                suppressed = 0
                for t in range(live):
                    if (kept >> t) & 1:
                        suppressed |= diag[t]
                if alive & ~suppressed == kept:
                    break
                kept = alive & ~suppressed
            removed[r] |= suppressed
            for w in range(r + 1, nb):
                for t in range(_WORD):
                    if (kept >> t) & 1:
                        removed[w] |= int(words[r * _WORD + t, w]) & _U64
        for i in range(k):
            keep[b, i] = not (removed[i // _WORD] >> (i % _WORD)) & 1
    return keep


def _non_prefix(rng, bsz, k):
    boxes, _ = _batch(rng, bsz, k, [k] * bsz)
    valid = rng.random((bsz, k)) < 0.6
    valid[:, 0] = False
    return boxes, valid


def _flat_boxes(rng, bsz, k):
    """Wide, flat boxes: many disjoint pairs with a DIoU above -0.1."""
    cxy = rng.uniform(0.2, 0.8, (bsz, k, 2))
    wh = np.stack([rng.uniform(0.2, 0.4, (bsz, k)), rng.uniform(0.005, 0.02, (bsz, k))], -1)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    return boxes, np.arange(k)[None] < np.asarray([k, k // 2])[:, None]


EMULATION_EXTRA = {
    # name: (inputs(rng), thresholds, kind, beta1)
    "non_prefix_valid": (lambda rng: _non_prefix(rng, 2, 200), (0.3,), "iou", 1.0),
    "non_prefix_valid_diou": (lambda rng: _non_prefix(rng, 2, 150), (0.3,), "diou", 1.0),
    "negative_thr_diou": (lambda rng: _flat_boxes(rng, 2, 130), (-0.1,), "diou", 1.0),
    "k1": (lambda rng: _batch(rng, 2, 1, [1, 0]), (0.3,), "iou", 1.0),
    "k63": (lambda rng: _batch(rng, 2, 63, [63, 20], ties=True), (0.3,), "iou", 1.0),
    "k64": (lambda rng: _batch(rng, 2, 64, [64, 64], duplicates=True), (0.3, 0.45), "diou", 1.0),
    "k65": (lambda rng: _batch(rng, 2, 65, [65, 64]), (0.3,), "iou", 1.0),
    "k129": (lambda rng: _batch(rng, 2, 129, [129, 128], ties=True), (0.3,), "diou", 1.0),
    "diou_beta_0.6": (lambda rng: _batch(rng, 2, 150, [150, 90]), (0.3, 0.45), "diou", 0.6),
}


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_algorithm_equals_plain(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    for thr in (0.3, 0.45):
        want = _plain(boxes, valid, thr, kind)
        np.testing.assert_array_equal(_k1_emulation(boxes, valid, thr, kind), want)


@pytest.mark.parametrize("case", sorted(EMULATION_EXTRA))
def test_kernel_algorithm_equals_plain_edge_cases(rng, case):
    make, thresholds, kind, beta1 = EMULATION_EXTRA[case]
    boxes, valid = make(rng)
    for thr in thresholds:
        want = TN.nms_keep_sorted(
            torch.from_numpy(boxes), torch.from_numpy(valid), thr, kind, beta1
        ).numpy()
        np.testing.assert_array_equal(_k1_emulation(boxes, valid, thr, kind, beta1), want)
        assert not (want & ~valid).any()


def test_compact_keep_matches_jax(rng):
    k, max_out = 50, 20
    keep = rng.random((3, k)) < 0.6
    keep[2] = False
    order = np.stack([rng.permutation(k) for _ in range(3)]).astype(np.int32)
    packed, out_valid = TN.compact_keep(
        torch.from_numpy(keep), torch.from_numpy(order)[..., None], max_out
    )
    for b in range(3):
        idx, val = JN.compact_keep(jnp.asarray(keep[b]), jnp.asarray(order[b]), max_out)
        np.testing.assert_array_equal(out_valid[b].numpy(), np.asarray(val))
        np.testing.assert_array_equal(packed[b, :, 0].numpy(), np.asarray(idx))
