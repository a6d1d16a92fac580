"""PyTorch port, greedy NMS: the plain version (the oracle of the CUDA
kernel) gives keep masks EQUAL to the JAX package's XLA NMS and to its
Pallas kernel in interpret mode; the wrapper's CPU dispatch; and a torch
emulation of the CUDA kernel's algorithm (the walk: each chunk
tested against the kept rows, its own greedy order resolved 64 rows at a
time) gives the plain version's keep masks. The CUDA kernel itself is held
against the plain version on the card by `chip_smoke.py` (these tests
import jax, which that machine lacks).
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


def _bits(flags) -> int:
    """The integer whose bit t is flags[t]."""
    return sum(1 << t for t in np.flatnonzero(flags).tolist())


def _suppress_matrix(rows, cols, thr, kind, beta1):
    """bool [R, C]: metric(row i, column j) > thr as the kernel evaluates
    it, row i on the `bi` side and column j on the `boxes` side; a pair
    with inter == 0 skipped when thr >= 0."""
    r, c = rows.shape[0], cols.shape[0]
    areas = (cols[:, 2] - cols[:, 0]) * (cols[:, 3] - cols[:, 1])
    sup = TN._metric(rows, cols.expand(r, c, 4), areas.expand(r, c), kind, beta1) > thr
    if thr >= 0:  # the kernel's early-out: a disjoint pair never suppresses
        x = torch.clamp(torch.minimum(rows[:, None, 2], cols[None, :, 2])
                        - torch.maximum(rows[:, None, 0], cols[None, :, 0]), min=0.0)
        y = torch.clamp(torch.minimum(rows[:, None, 3], cols[None, :, 3])
                        - torch.maximum(rows[:, None, 1], cols[None, :, 1]), min=0.0)
        sup &= x * y != 0
    return sup.numpy()


def _k1_emulation(boxes, valid, thr, kind, beta1=1.0, width=None, chunk=None, cap=None, seed=0):
    """`csrc/nms.cu`'s walk on the CPU, under nms_cuda.plan's width, chunk
    and cap unless given; with width > 1 block 0 resolves and the other
    blocks test (testers = width - 1), with width 1 the one block does both.
    Per image: n_valid and end (the last valid index + 1); the chunks
    [s, s + chunk) below end, a chunk with no valid candidate skipped. Per
    chunk, each tester tests the chunk's valid candidates against its slice
    of the kept list (its shared memory, `min(mine, cap)` rows, then its
    overflow positions trank, trank + testers, ...: every row kept before
    the chunk, some before the last chunk's survivors are appended and the
    rest after, an OR either way) and ORs the suppressed bits; builds the
    triangle words of its rows (r % testers == trank, valid, below n_valid;
    words q >= r // 64 only) into block 0's buffer, whose other words are
    garbage, then stale words of earlier chunks; block 0 resolves 64 rows
    at a time: the survivors of the earlier 64-row blocks' words pulled in,
    then the fixed point over the diagonal words of the alive rows,
    iterated from all of them; keep = not removed; the survivors are
    appended by rank g = their order among the kept rows, tester g %
    testers, slot g // testers while g < testers * cap, else overflow
    position g - testers * cap. Returns (keep [B, K] bool, the metric
    evaluations the kernel makes)."""
    boxes_t = torch.from_numpy(boxes)
    bsz, k = valid.shape
    pl = nms_cuda.plan(bsz, k)
    width, chunk, cap = width or pl.width, chunk or pl.chunk, pl.cap if cap is None else cap
    testers = max(1, width - 1)
    nw = chunk // _WORD
    garbage = np.random.default_rng(seed).integers(-(2**63), 2**63 - 1, (chunk, nw), dtype=np.int64)
    tri = [[int(x) & _U64 for x in row] for row in garbage]
    keep = np.zeros((bsz, k), bool)
    pairs = 0
    for b in range(bsz):
        bx = boxes_t[b]
        n_valid = int(valid[b].sum())
        end = int(np.flatnonzero(valid[b])[-1]) + 1 if n_valid else 0
        walk_end = min(k, -(-end // chunk) * chunk)
        slices = [[] for _ in range(testers)]  # each tester's shared memory, slot by slot
        overflow = {}  # position -> candidate index
        total = 0
        for s in range(0, walk_end, chunk):
            ln = min(chunk, k - s)
            cvalid = np.zeros(chunk, bool)
            cvalid[:ln] = valid[b, s : s + ln]
            if not cvalid.any():
                continue
            cols = bx[s : s + ln]
            own = _suppress_matrix(cols, cols, thr, kind, beta1)  # the chunk's pairs
            sup = 0
            for trank in range(testers):
                mine = -(-(total - trank) // testers) if total > trank else 0
                assert len(slices[trank]) == min(mine, cap)
                entries = list(slices[trank])
                ov_total = total - testers * cap
                if ov_total > trank:
                    entries += [overflow[trank + n * testers] for n in range(-(-(ov_total - trank) // testers))]
                if entries:
                    hit = _suppress_matrix(bx[entries], cols, thr, kind, beta1).any(0) & cvalid[:ln]
                    sup |= _bits(hit)
                    pairs += len(entries) * int(cvalid.sum())
                for r in range(trank, ln, testers):
                    if s + r >= n_valid or not cvalid[r]:
                        continue
                    live = cvalid[:ln] & (np.arange(ln) > r)
                    pairs += int(live.sum())
                    row = _bits(own[r] & live)
                    for q in range(r // _WORD, nw):
                        tri[r][q] = (row >> (_WORD * q)) & _U64
            rem = [((~_bits(cvalid) | sup) >> (_WORD * q)) & _U64 for q in range(nw)]
            kept_words = []
            for q in range(nw):
                for q1 in range(q):  # the earlier blocks' survivors
                    for t in range(_WORD):
                        if (kept_words[q1] >> t) & 1:
                            rem[q] |= tri[_WORD * q1 + t][q]
                live = min(_WORD, max(0, n_valid - (s + _WORD * q)))
                alive = ~rem[q] & ((1 << live) - 1)
                kept = alive
                while True:  # survivors = alive minus what the survivors suppress
                    suppressed = 0
                    for t in range(_WORD):
                        if (kept >> t) & 1:
                            suppressed |= tri[_WORD * q + t][q]
                    if alive & ~suppressed == kept:
                        break
                    kept = alive & ~suppressed
                rem[q] |= suppressed
                kept_words.append(kept)
            for t in range(ln):
                keep[b, s + t] = not (rem[t // _WORD] >> (t % _WORD)) & 1
            for t in range(ln):
                if (kept_words[t // _WORD] >> (t % _WORD)) & 1:
                    g, total = total, total + 1
                    if g // testers < cap:
                        slices[g % testers].append(s + t)
                    else:
                        overflow[g - testers * cap] = s + t
    return keep, pairs


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


# The plan's launch (one chunk up to K 256), and chunks of 64 over four
# blocks holding 5 kept rows each, the rest in the overflow list.
_WALKS = ({}, dict(width=4, chunk=64, cap=5))


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_algorithm_equals_plain(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    for thr in (0.3, 0.45):
        want = _plain(boxes, valid, thr, kind)
        for walk in _WALKS:
            np.testing.assert_array_equal(_k1_emulation(boxes, valid, thr, kind, **walk)[0], want, err_msg=f"{walk}")


@pytest.mark.parametrize("case", sorted(EMULATION_EXTRA))
def test_kernel_algorithm_equals_plain_edge_cases(rng, case):
    make, thresholds, kind, beta1 = EMULATION_EXTRA[case]
    boxes, valid = make(rng)
    for thr in thresholds:
        want = TN.nms_keep_sorted(
            torch.from_numpy(boxes), torch.from_numpy(valid), thr, kind, beta1
        ).numpy()
        for walk in _WALKS:
            np.testing.assert_array_equal(_k1_emulation(boxes, valid, thr, kind, beta1, **walk)[0], want,
                                          err_msg=f"{walk}")
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
