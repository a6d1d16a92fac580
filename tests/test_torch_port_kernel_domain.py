"""PyTorch port, both kernels over the JAX kernels' whole domain: K1 (greedy
NMS, csrc/nms.cu) for any number of candidates K, K2 (matching front half,
csrc/matching.cu) for any number of GT rows G.

- K1's plan (`nms_cuda.plan`): its bands cover every 64-row block once and
  each row block's column chunks cover every mask word once; the scratch
  stays within the budget up to (B, K) = (8, 67,200) and (1, 272,000), one
  band holds K <= 12,288 at B <= 32, and what the kernels cannot take
  raises before any allocation.
- Torch emulations of the new algorithms, held EXACTLY to the plain
  versions: K1's banded scan, column chunk by column chunk, over one
  scratch buffer that every band reuses (stale words from the band before
  stand for garbage), with `removed` carried from band to band and the
  bands past ceil(n_valid / 64) left out; K2's walk over the GT rows in
  chunks, the running best per prior carried across chunks, ties across a
  chunk's edge, an image whose only valid rows lie in a later chunk.
- The paths that reach the sizes, against the JAX package: the
  postprocess at pre_nms_topk = P = 16,800 (the flagship's anchors at
  640x640), valid masks exact and rows within 1e-6 (the bound of
  tests/test_torch_port_predict.py), and the Pallas NMS kernel in
  interpret mode on its 16,800 candidates, keep masks exact; `multibox_loss` and the matching at
  max_targets = 300 against the XLA matching and `match_batch_pallas` in
  interpret mode, with the bounds of tests/test_torch_port_loss.py.

The CUDA kernels themselves are held against the plain versions at these
sizes on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import losses as JL
from jabd_tpu import predict as JP
from jabd_tpu.ops import anchors as JA
from jabd_tpu.ops import nms_pallas as JNP
from jabd_tpu.ops.matching_pallas import _match_front as jax_match_front_pallas
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import predict as TP
from jabd_tpu_torch.ops import matching as TM
from jabd_tpu_torch.ops import matching_cuda
from jabd_tpu_torch.ops import nms as TN
from jabd_tpu_torch.ops import nms_cuda
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_nms import CASES, _batch, _flat_boxes, _non_prefix

WORD = nms_cuda.WORD


# ---------------------------------------------------------------------------
# K1's plan
# ---------------------------------------------------------------------------

PLAN_SIZES = [(1, 1), (8, 5000), (32, 12288), (8, 16800), (2, 67200), (8, 67200),
              (1, 272000), (4, 272000), (1, nms_cuda.MAX_K), (3, 1000)]


def _check_plan(bsz, k, pl, budget):
    nb = -(-k // WORD)
    assert pl.bands[0][0] == 0 and pl.bands[-1][1] == nb
    rows = [r for r0, r1 in pl.bands for r in range(r0, r1)]
    assert rows == list(range(nb))  # every row block once, in order
    for r0, r1 in pl.bands:
        assert r1 > r0
        assert bsz * (r1 - r0) * (nb - r0) * WORD <= pl.mask_words  # the band fits its scratch
    assert pl.removed_words == bsz * nb and 2 * pl.count_words >= bsz
    assert pl.scratch_bytes <= budget
    assert 1 <= pl.chunk <= min(nb, nms_cuda.CHUNK)
    assert 2 * pl.chunk * WORD * 8 + 8 * nb <= nms_cuda.SCAN_SMEM  # buffers and `removed`
    for r in {0, nb // 2, nb - 1}:  # each row block's columns r .. nb-1, chunk by chunk
        cols = [c for c0 in range(r, nb, pl.chunk) for c in range(c0, min(nb, c0 + pl.chunk))]
        assert cols == list(range(r, nb))


@pytest.mark.parametrize("bsz,k", PLAN_SIZES)
def test_plan_covers_every_block_once_within_the_budget(bsz, k, monkeypatch):
    pl = nms_cuda.plan(bsz, k)
    _check_plan(bsz, k, pl, nms_cuda.SCRATCH_BYTES)
    # Tight budgets: many bands, each still within the budget.
    nb = -(-k // WORD)
    tight = 8 * (bsz * nb + -(-bsz // 2)) + 3 * bsz * nb * WORD * 8
    monkeypatch.setattr(nms_cuda, "SCRATCH_BYTES", tight)
    pl = nms_cuda.plan(bsz, k)
    _check_plan(bsz, k, pl, tight)
    assert pl.bands[0] == (0, min(nb, 3))  # three row blocks in the first band


@pytest.mark.parametrize("k", [1, 64, 5000, 12288])
def test_plan_one_band_up_to_12288_at_b32(k):
    for bsz in range(1, 33):
        pl = nms_cuda.plan(bsz, k)
        assert pl.bands == ((0, -(-k // WORD)),), (bsz, k)
        assert pl.chunk == -(-k // WORD)  # one chunk a row block


def test_plan_at_the_chip_smoke_sizes():
    """The shapes chip_smoke.py runs: chunks of 192 words, and the band
    counts the kernel's launches follow; at MAX_K the chunks shrink to
    MIN_CHUNK words beside 194 KB of removed bits."""
    assert [len(nms_cuda.plan(b, k).bands) for b, k in
            ((8, 16800), (2, 67200), (8, 67200), (1, 272000))] == [1, 2, 3, 6]
    assert nms_cuda.plan(1, 272000).chunk == 192
    assert nms_cuda.MAX_K == 1_589_248 and nms_cuda.plan(1, nms_cuda.MAX_K).chunk == nms_cuda.MIN_CHUNK


def test_plan_raises_on_what_the_kernels_cannot_take(monkeypatch):
    for k in (nms_cuda.MAX_K + 1, 2**31):
        with pytest.raises(ValueError, match="shared memory"):
            nms_cuda.plan(1, k)
    with pytest.raises(ValueError, match="scratch budget"):
        nms_cuda.plan(84, nms_cuda.MAX_K)  # one row block of the batch: 1.07 GB
    monkeypatch.setattr(nms_cuda, "SCRATCH_BYTES", 2 * 79 * 512)  # room for the bits, not for a row block
    with pytest.raises(ValueError, match="scratch budget"):
        nms_cuda.plan(2, 5000)


# ---------------------------------------------------------------------------
# K1's banded, column-chunked algorithm
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def _words(boxes, valid, thr, kind, beta1):
    """Per image, the mask words the mask kernel writes for rows i <
    n_valid: uint64 [n_valid, nb] (bit c of word (i, cb): j = 64 cb + c > i
    and metric(i, j) > thr; 0 for an invalid row or a column block with no
    valid box; a disjoint pair skipped when thr >= 0)."""
    bsz, k = valid.shape
    nb = -(-k // WORD)
    boxes_t, valid_t = torch.from_numpy(boxes), torch.from_numpy(valid)
    areas = (boxes_t[..., 2] - boxes_t[..., 0]) * (boxes_t[..., 3] - boxes_t[..., 1])
    cols = torch.arange(k)
    out = []
    for b in range(bsz):
        n = int(valid[b].sum())
        rows = boxes_t[b, :n]
        metric = TN._metric(rows, boxes_t[b].expand(n, k, 4), areas[b].expand(n, k), kind, beta1)
        sup = (metric > thr) & (cols[None] > torch.arange(n)[:, None])
        if thr >= 0:
            x = torch.clamp(torch.minimum(rows[:, None, 2], boxes_t[b, None, :, 2])
                            - torch.maximum(rows[:, None, 0], boxes_t[b, None, :, 0]), min=0.0)
            y = torch.clamp(torch.minimum(rows[:, None, 3], boxes_t[b, None, :, 3])
                            - torch.maximum(rows[:, None, 1], boxes_t[b, None, :, 1]), min=0.0)
            sup &= x * y != 0
        sup &= valid_t[b, :n, None]
        bits = np.zeros((n, nb * WORD), np.uint64)
        bits[:, :k] = sup.numpy()
        words = (bits.reshape(n, nb, WORD) << np.arange(WORD, dtype=np.uint64)).sum(-1, dtype=np.uint64)
        padded = np.zeros(nb * WORD, bool)
        padded[:k] = valid[b]
        words[:, ~padded.reshape(nb, WORD).any(1)] = 0
        out.append(words)
    return out


def _k1_banded_emulation(boxes, valid, thr, kind, pl, beta1=1.0, seed=0):
    """`csrc/nms.cu` under the plan `pl` on the CPU: per band [r0, r1), the
    mask kernel writes word (64 rb + t, cb) at ((b R + rb - r0) W + cb -
    r0) 64 + t (R = r1 - r0, W = nb - r0) of one scratch buffer for rb in
    [r0, min(r1, steps)), cb >= rb and rows below n_valid, and leaves every
    other word as it was (garbage at first, then the band before's words);
    the scan of an image builds `removed` in the first band, skips a band
    with r0 >= steps, walks each row block's columns in chunks of
    pl.chunk words (resolving the diagonal on the first), and writes keep =
    ~removed in the band that reaches steps; the other bands hand
    `removed` on."""
    bsz, k = valid.shape
    nb = -(-k // WORD)
    buf = np.random.default_rng(seed).integers(-(2**63), 2**63 - 1, pl.mask_words, dtype=np.int64)
    buf = buf.view(np.uint64)
    words = _words(boxes, valid, thr, kind, beta1)
    counts = {}
    removed = {}
    keep = {}
    for r0, r1 in pl.bands:
        rows_b, width = r1 - r0, nb - r0
        for b in range(bsz):  # the mask kernel
            n = int(valid[b].sum())
            if r0 == 0:
                counts[b] = n
            end = min(r1, -(-counts[b] // WORD))
            for rb in range(r0, end):
                live = min(WORD, n - rb * WORD)
                for cb in range(rb, nb):
                    at = ((b * rows_b + rb - r0) * width + cb - r0) * WORD
                    buf[at : at + live] = words[b][rb * WORD : rb * WORD + live, cb]
        for b in range(bsz):  # the scan
            n = counts[b]
            steps = -(-n // WORD)
            if r0 == 0:
                rem = []
                for w in range(nb):
                    bits = 0
                    for c in range(WORD):
                        j = w * WORD + c
                        if j < k and valid[b, j]:
                            bits |= 1 << c
                    rem.append(~bits & _U64)
                removed[b] = rem
            elif r0 >= steps:
                continue
            rem = removed[b]
            end = min(r1, steps)
            for r in range(r0, end):
                kept = 0
                for c in range(r, nb, pl.chunk):
                    ln = min(pl.chunk, nb - c)
                    at = ((b * rows_b + r - r0) * width + c - r0) * WORD
                    chunk = [int(x) for x in buf[at : at + ln * WORD]]
                    if c == r:
                        live = min(WORD, n - r * WORD)
                        alive = ~rem[r] & ((1 << live) - 1)
                        kept = alive
                        while True:
                            suppressed = 0
                            for t in range(WORD):
                                if (kept >> t) & 1:
                                    suppressed |= chunk[t]
                            if alive & ~suppressed == kept:
                                break
                            kept = alive & ~suppressed
                        rem[r] |= suppressed
                    for w in range(1 if c == r else 0, ln):
                        for t in range(WORD):
                            if (kept >> t) & 1:
                                rem[c + w] |= chunk[w * WORD + t]
            if end < steps:
                continue
            assert b not in keep, "an image's keep mask is written once"
            keep[b] = [not (rem[i // WORD] >> (i % WORD)) & 1 for i in range(k)]
    return np.asarray([keep[b] for b in range(bsz)], bool).reshape(bsz, k)


def _small_plan(bsz, k, rows=2, chunk=2):
    """A plan of bands `rows` row blocks deep at first (deeper as the
    triangle narrows) and column chunks of `chunk` words."""
    nb = -(-k // WORD)
    budget = 8 * (bsz * nb + -(-bsz // 2)) + rows * bsz * nb * WORD * 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nms_cuda, "SCRATCH_BYTES", budget)
        pl = nms_cuda.plan(bsz, k)
    return pl._replace(chunk=min(chunk, nb))


def _plain(boxes, valid, thr, kind, beta1=1.0):
    return TN.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), thr, kind, beta1).numpy()


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_kernel_algorithm_equals_plain(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    k = valid.shape[1]
    for rows, chunk in ((1, 1), (2, 2), (2, 5)):
        pl = _small_plan(valid.shape[0], k, rows, chunk)
        assert len(pl.bands) > 1
        for thr in (0.3, 0.45):
            got = _k1_banded_emulation(boxes, valid, thr, kind, pl)
            np.testing.assert_array_equal(got, _plain(boxes, valid, thr, kind), err_msg=f"{pl}")


BANDED_EXTRA = {
    # name: (inputs(rng), threshold, kind, beta1, rows, chunk)
    "non_prefix_valid": (lambda rng: _non_prefix(rng, 2, 200), 0.3, "iou", 1.0, 1, 2),
    "non_prefix_valid_diou": (lambda rng: _non_prefix(rng, 2, 300), 0.3, "diou", 1.0, 2, 3),
    "negative_thr_diou": (lambda rng: _flat_boxes(rng, 2, 200), -0.1, "diou", 1.0, 1, 1),
    "k1": (lambda rng: _batch(rng, 2, 1, [1, 0]), 0.3, "iou", 1.0, 1, 1),
    "k63": (lambda rng: _batch(rng, 2, 63, [63, 20], ties=True), 0.3, "iou", 1.0, 1, 1),
    "k64": (lambda rng: _batch(rng, 2, 64, [64, 64], duplicates=True), 0.3, "diou", 1.0, 1, 1),
    "k65": (lambda rng: _batch(rng, 2, 65, [65, 64]), 0.3, "iou", 1.0, 1, 1),
    "k1000": (lambda rng: _batch(rng, 2, 1000, [1000, 700]), 0.3, "iou", 1.0, 2, 3),
    "k1000_ties_diou_beta": (lambda rng: _batch(rng, 2, 1000, [1000, 130], ties=True), 0.45, "diou", 0.6, 3, 4),
    "k1000_empty_and_one": (lambda rng: _batch(rng, 3, 1000, [0, 1, 999], zero_area=True), 0.3, "iou", 1.0, 2, 2),
}


@pytest.mark.parametrize("case", sorted(BANDED_EXTRA))
def test_banded_kernel_algorithm_equals_plain_edge_cases(rng, case):
    make, thr, kind, beta1, rows, chunk = BANDED_EXTRA[case]
    boxes, valid = make(rng)
    pl = _small_plan(valid.shape[0], valid.shape[1], rows, chunk)
    want = _plain(boxes, valid, thr, kind, beta1)
    np.testing.assert_array_equal(_k1_banded_emulation(boxes, valid, thr, kind, pl, beta1), want)
    assert not (want & ~valid).any()
    if valid.shape[1] == 1000:
        assert len(pl.bands) >= 4


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES) + ["non_prefix_valid"])
def test_greedy_rule_check_accepts_plain_and_nothing_else(rng, case, kind):
    """chip_smoke.greedy_rule_holds, which holds K1 at K 272,000 with 99%
    valid rows on the card: true for the plain loop's mask, false once any
    one valid position is flipped (or an invalid one kept)."""
    import chip_smoke

    boxes, valid = _non_prefix(rng, 2, 200) if case == "non_prefix_valid" else _batch(rng, **CASES[case])
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    for thr in (0.3, 0.45, -0.1):
        want = TN.nms_keep_sorted(boxes, valid, thr, kind)
        assert chip_smoke.greedy_rule_holds(boxes, valid, want, thr, kind, rows=7)
        for b in range(valid.shape[0]):
            for j in torch.nonzero(valid[b]).flatten()[:: 17].tolist() + [0]:
                bad = want.clone()
                bad[b, j] = ~bad[b, j]
                assert not chip_smoke.greedy_rule_holds(boxes, valid, bad, thr, kind, rows=7), (b, j, thr)


def test_anchor_candidates_cover_every_band():
    """chip_smoke's K 272,000 load: re152_4level's anchors at 1280x1280,
    99% valid, so n_valid reaches the last of the plan's 6 bands."""
    import chip_smoke

    boxes, valid = chip_smoke.anchor_candidates(272000)
    assert boxes.shape == (1, 272000, 4) and boxes.dtype == torch.float32
    assert bool((boxes[..., 2:] > boxes[..., :2]).all())
    bands = nms_cuda.plan(1, 272000).bands
    assert len(bands) == 6 and -(-int(valid.sum()) // WORD) > bands[-1][0]


def test_wrapper_takes_the_plain_version_on_cpu_past_12288(rng):
    boxes, valid = _batch(rng, 1, 12289, [300])
    before = nms_cuda.nms_keep_sorted.launches
    got = nms_cuda.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3)
    np.testing.assert_array_equal(got.numpy(), _plain(boxes, valid, 0.3, "iou"))
    assert nms_cuda.nms_keep_sorted.launches == before  # no kernel ran


# ---------------------------------------------------------------------------
# K2's walk over GT rows in chunks
# ---------------------------------------------------------------------------

TILE = 1024


def _priors():
    return JA.generate_anchors(JC.get_model_config("jabd_flagship").anchors, (384, 384)).copy()


def _k2_chunked_emulation(truths, priors, valid, chunk):
    """`csrc/matching.cu` on the CPU: per tile of 1024 priors, the GT rows
    in chunks of `chunk`, ascending; per chunk the valid rows that meet the
    tile's bounding box are visited with a strict '>' against each prior's
    running best, which starts at (+0, j0), j0 the image's first valid row
    over all chunks, found before the first (or at (-1, 0) without one), and
    carries across chunks. Per GT the tile's first maximum, (+0, the tile's
    first prior) for a culled row, then the first tile's on ties. The last
    tile's slots past P take part in each GT's tile maximum as the kernel
    runs them, with zero corners: they must never win."""
    truths, priors, valid = (torch.from_numpy(a) for a in (truths, priors, valid))
    bsz, g = valid.shape
    p = priors.shape[0]
    px1, py1 = priors[:, 0] - priors[:, 2] / 2, priors[:, 1] - priors[:, 3] / 2
    px2, py2 = priors[:, 0] + priors[:, 2] / 2, priors[:, 1] + priors[:, 3] / 2
    parea = (px2 - px1) * (py2 - py1)
    ntiles = -(-p // TILE)
    pad = ntiles * TILE - p  # the last tile's slots past P: zero corners
    px1, py1, px2, py2, parea = (torch.cat([x, torch.zeros(pad)]) for x in (px1, py1, px2, py2, parea))
    tx1, ty1, tx2, ty2 = truths.unbind(-1)
    area_t = (tx2 - tx1) * (ty2 - ty1)
    bt_ov = torch.empty((bsz, p), dtype=torch.float32)
    bt_ix = torch.empty((bsz, p), dtype=torch.int64)
    tile_max = torch.full((bsz, ntiles, g), -1.0)
    tile_arg = torch.zeros((bsz, ntiles, g), dtype=torch.int64)
    for t in range(ntiles):
        sl = slice(t * TILE, min(p, (t + 1) * TILE))
        X1, Y1, X2, Y2 = px1[sl].min(), py1[sl].min(), px2[sl].max(), py2[sl].max()
        hit = (valid & (torch.minimum(tx2, X2) - torch.maximum(tx1, X1) > 0)
               & (torch.minimum(ty2, Y2) - torch.maximum(ty1, Y1) > 0))
        for b in range(bsz):
            firsts = torch.nonzero(valid[b]).flatten()
            n = sl.stop - sl.start
            best = torch.full((n,), 0.0 if len(firsts) else -1.0)
            idx = torch.full((n,), int(firsts[0]) if len(firsts) else 0, dtype=torch.int64)
            for c0 in range(0, g, chunk):
                rows = [j for j in range(c0, min(g, c0 + chunk)) if valid[b, j]]
                for j in rows:
                    if not hit[b, j]:
                        tile_max[b, t, j], tile_arg[b, t, j] = 0.0, sl.start
                        continue
                    iw = torch.clamp(torch.minimum(tx2[b, j], px2[sl]) - torch.maximum(tx1[b, j], px1[sl]), min=0.0)
                    ih = torch.clamp(torch.minimum(ty2[b, j], py2[sl]) - torch.maximum(ty1[b, j], py1[sl]), min=0.0)
                    inter = iw * ih
                    iou = torch.where(inter == 0, 0.0, inter / ((area_t[b, j] + parea[sl]) - inter))
                    better = iou > best
                    best = torch.where(better, iou, best)
                    idx = torch.where(better, j, idx)
                    slots = slice(sl.start, sl.start + TILE)  # the tile's slots, past P too
                    iw = torch.clamp(torch.minimum(tx2[b, j], px2[slots]) - torch.maximum(tx1[b, j], px1[slots]),
                                     min=0.0)
                    ih = torch.clamp(torch.minimum(ty2[b, j], py2[slots]) - torch.maximum(ty1[b, j], py1[slots]),
                                     min=0.0)
                    inter = iw * ih
                    iou = torch.where(inter == 0, 0.0, inter / ((area_t[b, j] + parea[slots]) - inter))
                    tile_max[b, t, j] = iou.max()
                    tile_arg[b, t, j] = sl.start + torch.argmax(iou)
            bt_ov[b, sl] = best
            bt_ix[b, sl] = idx
    first_tile = torch.argmax(tile_max, dim=1, keepdim=True)
    bp_ix = torch.where(valid, torch.gather(tile_arg, 1, first_tile)[:, 0], 0)
    return bt_ov, bt_ix, bp_ix


def _corners(cxcywh):
    return np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2, cxcywh[:, :2] + cxcywh[:, 2:] / 2], 1)


def _face_boxes(rng, n):
    cxy = rng.uniform(0.05, 0.95, (n, 2))
    wh = rng.uniform(0.01, 0.25, (n, 2))
    return np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], 1), 0.0, 1.0).astype(np.float32)


def chunk_cases(priors, g, chunk, seed=0):
    """[5, G, 4] truths, [5, G] valid, one kind per image: (0) G random
    faces; (1) copies of row 3 at rows chunk - 1, chunk, chunk + 7 and
    G - 1, and four prior boxes at rows chunk - 5 .. chunk - 2 copied to
    rows chunk + 1 .. chunk + 4 (exact ties across the chunk's edge: the
    lower row must win); (2) valid rows only from row chunk on; (3) one
    valid row, the last; (4) none. Rows past G are left out."""
    rng = np.random.default_rng(seed)
    truths = np.stack([_face_boxes(rng, g) for _ in range(5)])
    valid = np.ones((5, g), bool)
    pick = rng.choice(len(priors), 4, replace=False)
    truths[1, chunk - 5 : chunk - 1] = _corners(priors[pick].astype(np.float64)).astype(np.float32)
    for lo, hi in zip(range(chunk - 5, chunk - 1), range(chunk + 1, chunk + 5)):
        if hi < g:
            truths[1, hi] = truths[1, lo]
    for row in (chunk - 1, chunk, chunk + 7, g - 1):
        if row < g:
            truths[1, row] = truths[1, 3]
    valid[2, :chunk] = False
    valid[2, chunk + 1 :: 3] = False
    valid[3, :-1] = False
    valid[4] = False
    return truths, valid


def _pallas_front(truths, priors, valid, like):
    """The Pallas kernel's front half (interpret mode) as tensors of
    `like`'s types."""
    out = jax_match_front_pallas(jnp.asarray(truths), jnp.asarray(priors), jnp.asarray(valid), interpret=True)
    return [torch.from_numpy(np.array(x)).to(y.dtype) for x, y in zip(out, like)]


def _assert_front_equal(got, want):
    for name, g, w in zip(("best_truth_overlap", "best_truth_idx", "best_prior_idx"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), name


@pytest.mark.parametrize("g,chunk", [(300, 256), (300, 16), (40, 16), (16, 16)])
def test_chunked_kernel_algorithm_equals_plain(g, chunk):
    priors = _priors()
    truths, valid = chunk_cases(priors, g, chunk)
    want = TM.match_front_plain(*(torch.from_numpy(a) for a in (truths, priors, valid)))
    _assert_front_equal(_k2_chunked_emulation(truths, priors, valid, chunk), want)
    # The cases do what they claim: ties across the chunk's edge go to the
    # lower row, the second-chunk image's rows start past the edge.
    bt_ov, bt_ix, bp_ix = want
    later = torch.tensor([r for r in (chunk - 1, chunk, chunk + 7, g - 1, *range(chunk + 1, chunk + 5)) if r < g])
    assert (bt_ix[1] == 3).any() and (bt_ov[1] == 1.0).sum() >= 4
    assert not torch.isin(bt_ix[1], later).any()  # a later copy of a GT never wins
    if g > chunk:
        assert bp_ix[1, chunk] == bp_ix[1, 3] and bp_ix[1, chunk + 1] == bp_ix[1, chunk - 5]
        assert int(bt_ix[2].min()) >= chunk and (bt_ix[2] == chunk).any()
    assert (bt_ov[4] == -1.0).all() and (bt_ix[4] == 0).all() and (bt_ix[3] == g - 1).all()


def test_matching_wrapper_takes_the_plain_version_on_cpu_past_256():
    priors = _priors()
    truths, valid = chunk_cases(priors, 300, 256)
    before = matching_cuda.match_front.launches
    got = matching_cuda.match_front(*(torch.from_numpy(a) for a in (truths, priors, valid)))
    assert matching_cuda.match_front.launches == before
    _assert_front_equal(got, _pallas_front(truths, priors, valid, got))


# ---------------------------------------------------------------------------
# The paths at the new sizes, against the JAX package
# ---------------------------------------------------------------------------


def test_postprocess_at_pre_nms_topk_16800_matches_jax():
    """pre_nms_topk = P = 16,800 (jabd_flagship's anchors at 640x640):
    every anchor is a candidate, K > 12,288."""
    anchors = JA.generate_anchors(JC.get_model_config("jabd_flagship").anchors, (640, 640)).copy()
    assert anchors.shape[0] == 16800
    rng = np.random.default_rng(13)
    loc = rng.normal(0, 1, (1, 16800, 4)).astype(np.float32)
    landm = rng.normal(0, 1, (1, 16800, 10)).astype(np.float32)
    s = rng.uniform(0, 1, (1, 16800)).astype(np.float32)
    s[:, ::3] = 0.75  # long runs of exactly equal scores
    cls = np.stack([1 - s, s], -1)
    kw = dict(confidence=0.6, input_shape=(640, 640), pre_nms_topk=16800, max_detections=750)
    jd, jv = JP.postprocess_outputs(*(jnp.asarray(a) for a in (loc, cls, landm, anchors)), JC.PredictConfig(**kw))
    td, tv = TP.postprocess_outputs(*(torch.from_numpy(a) for a in (loc, cls, landm, anchors)),
                                    TC.PredictConfig(**kw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 400 < int(tv.sum()) <= 750
    # stated tolerance 1e-6, as tests/test_torch_port_predict.py
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    # The Pallas kernel (interpret mode) on the same 16,800 candidates
    # gives the port's keep mask.
    boxes, _, valid, _ = TP.select_candidates(*(torch.from_numpy(a) for a in (loc, cls, landm, anchors)),
                                              TC.PredictConfig(**kw))
    assert valid.shape == (1, 16800)
    want = TN.nms_keep_sorted(boxes, valid, 0.3, "iou").numpy()
    got = JNP.nms_keep_sorted_pallas_batched(jnp.asarray(boxes.numpy()), jnp.asarray(valid.numpy()), 0.3,
                                             interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_multibox_loss_at_max_targets_300_matches_jax():
    """G = 300 GT rows (max_targets 300), 260 valid in one image: the port's
    loss (CPU: the plain matching) against the JAX package's with the XLA
    matching and with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(300)
    priors = JA.generate_anchors(JC.get_model_config("jabd_flagship").anchors, (128, 128)).copy()
    b, p, g = 2, priors.shape[0], 300
    loc = rng.normal(0, 0.5, (b, p, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (b, p, 2)).astype(np.float32)
    landm = rng.normal(0, 1, (b, p, 10)).astype(np.float32)
    boxes = np.stack([_face_boxes(rng, g) for _ in range(b)])
    labels = rng.choice([1.0, -1.0], (b, g)).astype(np.float32)
    landms = rng.uniform(0, 1, (b, g, 10)).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[1, 260:] = False
    boxes[1, 260:] = 0.0
    boxes[0, 256] = boxes[0, 255]  # a tie across the kernel's chunk edge
    preds = (loc, conf, landm)
    targets = (boxes, labels, landms, valid)

    leaves = [torch.tensor(a, requires_grad=True) for a in preds]
    parts = TL.multibox_loss(tuple(leaves), torch.from_numpy(priors),
                             TL.Targets(*(torch.from_numpy(a) for a in targets)))
    TL.total_loss(parts).backward()
    got = {k: float(v.detach()) for k, v in parts.items()}
    got_grads = [t.grad.numpy() for t in leaves]
    tg = JL.Targets(*(jnp.asarray(a) for a in targets))
    for impl in ("xla", "pallas_interpret"):
        want = JL.multibox_loss(tuple(jnp.asarray(a) for a in preds), jnp.asarray(priors), tg,
                                matching_impl=impl)
        for k in want:
            # stated 1e-5, as tests/test_torch_port_loss.py (summation order)
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=f"{k} vs {impl}")
    import jax

    def total(lo, co, la):
        return JL.total_loss(JL.multibox_loss((lo, co, la), jnp.asarray(priors), tg, matching_impl="xla"))

    want_grads = jax.grad(total, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in preds))
    for name, gr, w in zip(("loc", "conf", "landm"), got_grads, want_grads):
        # stated 1e-6 absolute and 1e-5 relative, as tests/test_torch_port_loss.py
        np.testing.assert_allclose(gr, np.asarray(w), atol=1e-6, rtol=1e-5, err_msg=name)
    # The port's matching at G 300 is the Pallas kernel's, bit for bit.
    front = TM.match_front_plain(*(torch.from_numpy(a) for a in (boxes, priors, valid)))
    _assert_front_equal(front, _pallas_front(boxes, priors, valid, front))
    assert int((front[2][0] == front[2][0, 255]).sum()) >= 2  # the tie is real
