"""PyTorch port, both kernels over the JAX kernels' whole domain: K1 (greedy
NMS, csrc/nms.cu) for any number of candidates K, K2 (matching front half,
csrc/matching.cu) for any number of GT rows G.

- K1's launch plan (`nms_cuda.plan`): blocks an image by B and the card's
  SMs, the shared memory within the block's limit, the overflow list
  within the scratch budget up to (B, K) = (1, MAX_K), and what the kernel
  cannot take raising before any allocation.
- Torch emulations of the new algorithms, held EXACTLY to the plain
  versions: K1's walk (`tests/test_torch_port_nms.py::_k1_emulation`)
  under 1 to 16 blocks an image, chunks of 64 to 512 and slices of one or a
  few kept rows, so that the overflow list holds the rest, with the
  evaluations it counts equal to chip_smoke.k1_work's closed form; K2's
  walk over the GT rows in
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
from tests.test_torch_port_nms import CASES, _batch, _flat_boxes, _k1_emulation, _non_prefix

WORD = nms_cuda.WORD


# ---------------------------------------------------------------------------
# K1's plan
# ---------------------------------------------------------------------------

PLAN_SIZES = [(1, 1), (8, 5000), (32, 12288), (8, 16800), (2, 67200), (8, 67200),
              (1, 272000), (4, 272000), (1, nms_cuda.MAX_K), (3, 1000)]


@pytest.mark.parametrize("bsz,k", PLAN_SIZES)
def test_plan_fits_shared_memory_and_scratch(bsz, k):
    """The launch fits the card: B * width blocks no more than its SMs
    (one block an SM, a cooperative launch) unless width is 1, chunks the
    kernel takes, the shared memory within SMEM with the slice taking what
    is left, and an overflow list for every candidate past the testers'
    slices, within the scratch budget with the exchange words."""
    pl = nms_cuda.plan(bsz, k)
    assert pl.width >= 1 and (pl.width == 1 or bsz * pl.width <= nms_cuda.SMS)
    assert pl.testers == max(1, pl.width - 1)
    assert pl.chunk in (64, 128, 256, 512) and pl.chunk >= min(k, nms_cuda.CHUNK)
    assert pl.smem_bytes <= nms_cuda.SMEM < pl.smem_bytes + nms_cuda.ENTRY_BYTES
    assert pl.smem_bytes == pl.chunk * pl.chunk // 8 + 16 * (pl.cap + nms_cuda.STAGE) + 40 * pl.chunk
    assert (pl.chunk * pl.chunk // 8) % 16 == 0  # the float4 arrays after the triangle words stay aligned
    assert pl.overflow_words == max(0, k - pl.testers * pl.cap)  # every candidate may be kept
    assert pl.exchange_words == 64 + pl.chunk * pl.chunk // 64
    assert pl.scratch_bytes == bsz * (8 * pl.exchange_words + 4 * pl.overflow_words) <= nms_cuda.SCRATCH_BYTES


@pytest.mark.parametrize("k", [1, 64, 5000, 67200])
def test_plan_width_by_batch(k):
    """width = min(SMs // B, ceil(K / 256)): the card's SMs shared among
    the images, no more blocks than 256 candidates each."""
    by_batch = {1: 132, 2: 66, 8: 16, 9: 14, 16: 8, 17: 7, 33: 4, 34: 3, 66: 2, 67: 1, 132: 1, 4096: 1}
    cap = -(-k // 256)
    assert {bsz: nms_cuda.plan(bsz, k).width for bsz in by_batch} == {b: min(w, cap) for b, w in by_batch.items()}
    assert nms_cuda.plan(1, k).chunk == min(512, max(64, 1 << (k - 1).bit_length()))


@pytest.mark.parametrize("bsz", [1, 8, 32])
def test_plan_width_follows_the_card(bsz):
    """The wrapper passes the card's SM count: a card with fewer SMs gets
    fewer blocks an image, never more blocks in all than it has SMs."""
    for sms in (1, 16, 78, 114, 132, 264):
        pl = nms_cuda.plan(bsz, 67200, sms=sms)
        assert pl.width == max(1, min(sms // bsz, 263))
        assert pl.width == 1 or bsz * pl.width <= sms
        assert pl.overflow_words == max(0, 67200 - pl.testers * pl.cap)


def test_plan_at_the_chip_smoke_sizes():
    """The shapes chip_smoke.py runs: 16 blocks an image at B 8 (15
    testers), 4 at B 32, the whole card at B 1 and 2; no overflow list up to
    ~160,000 kept rows an image at B 8; at MAX_K and B 1 the list takes the
    rest, well under a megabyte."""
    assert [nms_cuda.plan(b, k).width for b, k in
            ((8, 5000), (32, 5000), (8, 16800), (2, 67200), (8, 67200), (1, 272000))] == [16, 4, 16, 66, 16, 132]
    assert all(nms_cuda.plan(b, k).overflow_words == 0 for b, k in ((8, 67200), (32, 5000), (1, 272000)))
    pl = nms_cuda.plan(1, nms_cuda.MAX_K)
    assert pl.cap == 10880 and pl.overflow_words == nms_cuda.MAX_K - 131 * pl.cap
    assert nms_cuda.MAX_K == 1_589_248 and pl.scratch_bytes < 2**20


def test_plan_raises_on_what_the_kernels_cannot_take(monkeypatch):
    for k in (nms_cuda.MAX_K + 1, 2**31):
        with pytest.raises(ValueError, match="K <= 1589248"):
            nms_cuda.plan(1, k)
    with pytest.raises(ValueError, match="scratch budget"):
        nms_cuda.plan(200, nms_cuda.MAX_K)  # 200 images, one block each: 1.26 GB of overflow
    nms_cuda.plan(168, nms_cuda.MAX_K)  # 1.07 GB; the banded kernels' plan raised from B 84
    monkeypatch.setattr(nms_cuda, "SCRATCH_BYTES", nms_cuda.plan(1, nms_cuda.MAX_K).scratch_bytes - 1)
    with pytest.raises(ValueError, match="scratch budget"):
        nms_cuda.plan(1, nms_cuda.MAX_K)


class _CardTensor:
    """Stands for a contiguous, aligned tensor on the card: what the
    wrapper's checks read, and no storage."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def test_wrapper_plans_before_it_allocates(monkeypatch):
    """On the card the wrapper plans, and so raises past the domain,
    before it allocates anything."""
    order = []

    def plan(*args, **kwargs):
        order.append("plan")
        raise ValueError("K <= 1589248")

    monkeypatch.setattr(nms_cuda, "plan", plan)
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: order.append("empty"))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: type("P", (), {"multi_processor_count": 132}))
    k = nms_cuda.MAX_K + 1
    with pytest.raises(ValueError, match="K <= 1589248"):
        nms_cuda._launch(_CardTensor((1, k, 4), torch.float32), _CardTensor((1, k), torch.bool), 0.3, "iou", 1.0)
    assert order == ["plan"]


# ---------------------------------------------------------------------------
# K1's walk
# ---------------------------------------------------------------------------

# (width, chunk, cap): one block; 15 testers whose slices hold two kept rows
# each (the overflow list holds the rest); one tester; chunks of 256 and 512.
WALKS = [(1, 64, 10_000), (16, 64, 2), (2, 128, 3), (8, 256, 10_000), (4, 512, 5)]


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_equals_plain(rng, case, kind):
    boxes, valid = _batch(rng, **CASES[case])
    for width, chunk, cap in WALKS:
        for thr in (0.3, 0.45):
            got, _ = _k1_emulation(boxes, valid, thr, kind, width=width, chunk=chunk, cap=cap)
            np.testing.assert_array_equal(got, _plain(boxes, valid, thr, kind), err_msg=f"{(width, chunk, cap)}")


WALK_EXTRA = {
    # name: (inputs(rng), threshold, kind, beta1, width, chunk, cap)
    "non_prefix_valid": (lambda rng: _non_prefix(rng, 2, 200), 0.3, "iou", 1.0, 4, 64, 3),
    "non_prefix_valid_diou": (lambda rng: _non_prefix(rng, 2, 300), 0.3, "diou", 1.0, 2, 128, 1),
    "negative_thr_diou": (lambda rng: _flat_boxes(rng, 2, 200), -0.1, "diou", 1.0, 16, 64, 1),
    "k1": (lambda rng: _batch(rng, 2, 1, [1, 0]), 0.3, "iou", 1.0, 16, 64, 1),
    "k63": (lambda rng: _batch(rng, 2, 63, [63, 20], ties=True), 0.3, "iou", 1.0, 1, 64, 1),
    "k64": (lambda rng: _batch(rng, 2, 64, [64, 64], duplicates=True), 0.3, "diou", 1.0, 2, 64, 1),
    "k65": (lambda rng: _batch(rng, 2, 65, [65, 64]), 0.3, "iou", 1.0, 4, 64, 2),
    "k1000": (lambda rng: _batch(rng, 2, 1000, [1000, 700]), 0.3, "iou", 1.0, 8, 256, 20),
    "k1000_ties_diou_beta": (lambda rng: _batch(rng, 2, 1000, [1000, 130], ties=True), 0.45, "diou", 0.6,
                             4, 128, 5),
    "k1000_empty_and_one": (lambda rng: _batch(rng, 3, 1000, [0, 1, 999], zero_area=True), 0.3, "iou", 1.0,
                            16, 64, 4),
}


@pytest.mark.parametrize("case", sorted(WALK_EXTRA))
def test_walk_equals_plain_edge_cases(rng, case):
    make, thr, kind, beta1, width, chunk, cap = WALK_EXTRA[case]
    boxes, valid = make(rng)
    want = _plain(boxes, valid, thr, kind, beta1)
    got, _ = _k1_emulation(boxes, valid, thr, kind, beta1, width=width, chunk=chunk, cap=cap)
    np.testing.assert_array_equal(got, want)
    assert not (want & ~valid).any()
    if valid.shape[1] == 1000 and valid[0].all():
        assert want[0].sum() > max(1, width - 1) * cap  # the overflow list was used


@pytest.mark.parametrize("case,kind,chunk", [("random", "iou", 64), ("ties", "diou", 128),
                                             ("invalid_suffix", "iou", 256), ("non_prefix_valid", "diou", 64)])
def test_walk_counts_what_the_kernel_counts(rng, case, kind, chunk):
    """The evaluations the walk makes (k1.pairs) are chip_smoke.k1_work's
    closed form, the same whatever the width and slices; useful pairs
    (k1.useful_pairs) are no more than those: every (kept i, later valid j)
    pair is evaluated."""
    import chip_smoke

    boxes, valid = _non_prefix(rng, 2, 300) if case == "non_prefix_valid" else _batch(rng, **CASES[case])
    keep = _plain(boxes, valid, 0.3, kind)
    pairs, useful = chip_smoke.k1_work(torch.from_numpy(valid), torch.from_numpy(keep), chunk)
    for width, cap in ((1, 10_000), (4, 3), (16, 1)):
        got, evaluated = _k1_emulation(boxes, valid, 0.3, kind, width=width, chunk=chunk, cap=cap)
        np.testing.assert_array_equal(got, keep)
        assert evaluated == pairs
    prefix = (valid == (np.arange(valid.shape[1]) < valid.sum(1, keepdims=True))).all()
    assert useful <= pairs or not prefix


def _plain(boxes, valid, thr, kind, beta1=1.0):
    return TN.nms_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(valid), thr, kind, beta1).numpy()


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


def test_anchor_candidates_pass_one_blocks_shared_memory():
    """chip_smoke's K 272,000 load: re152_4level's anchors at 1280x1280,
    99% valid: more valid rows than one block's slice holds, which the
    whole card's testers hold at B 1, and which a batch that leaves one
    block an image carries in the overflow list."""
    import chip_smoke

    boxes, valid = chip_smoke.anchor_candidates(272000)
    assert boxes.shape == (1, 272000, 4) and boxes.dtype == torch.float32
    assert bool((boxes[..., 2:] > boxes[..., :2]).all())
    n = int(valid.sum())
    pl = nms_cuda.plan(1, 272000)
    assert pl.cap < n <= pl.testers * pl.cap and pl.overflow_words == 0
    assert nms_cuda.plan(67, 272000).overflow_words >= n - pl.cap


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
