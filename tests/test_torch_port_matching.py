"""PyTorch port, anchor matching (ops/matching.py, ops/matching_cuda.py)
against the JAX package: the dense XLA matching (`match_single`) and the
Pallas kernel `_match_front` run in interpret mode, on the same padded
batches, made with numpy.

The front half (best overlap and index per prior, best prior per GT) must
be equal: indices exactly, overlaps bit for bit. The full MatchResult:
conf_t and box_t exactly, loc_t and landm_t within a few float32 ulps
(log and division of the two libraries may round differently).

Each image of the batch is one case: ordinary random GTs, GTs that are
prior boxes (exact IoU 1 and exact ties between the prior's neighbours),
duplicate GTs (exact ties between GT rows), two GTs whose best prior is
the same one (the forced match: the last GT wins), padded rows after the
valid prefix, valid rows that are not a prefix, and no valid row at all.
At 384x384 there are 6048 priors, two tiles of the Pallas kernel.

A torch emulation of the CUDA kernel's algorithm (tiles of 1024 priors,
GTs culled by the tile's bounding box, per-prior bests started at
(+0, first valid row), per-GT tile maxima combined first tile first) must
give the plain front half bit for bit, on these cases, on a spread of GT
counts, and on GTs that touch a tile's bounding box exactly, cover the
whole image, or are an image's only valid row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.ops import anchors as JA
from jabd_tpu.ops import matching as JM
from jabd_tpu.ops.matching_pallas import _match_front as jax_match_front_pallas
from jabd_tpu.ops.matching_pallas import match_batch_pallas
from jabd_tpu_torch.ops import matching as TM
from jabd_tpu_torch.ops import matching_cuda

VAR = (0.1, 0.2)
THRESHOLD = 0.35
G = 16


def _corners(cxcywh):
    return np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2, cxcywh[:, :2] + cxcywh[:, 2:] / 2], 1)


def _random_boxes(rng, n):
    cxy = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.02, 0.3, (n, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)


def tie_cases(priors, seed=0):
    """[8, G, 4] truths, [8, G] labels, [8, G, 10] landms, [8, G] valid."""
    rng = np.random.default_rng(seed)
    b = 8
    truths = np.stack([_random_boxes(rng, G) for _ in range(b)])
    valid = np.ones((b, G), bool)
    # 1: GTs that are prior boxes: IoU exactly 1, and equal IoUs with
    #    the prior's equally placed neighbours.
    pick = rng.choice(len(priors), G, replace=False)
    truths[1] = _corners(priors[pick].astype(np.float64)).astype(np.float32)
    # 2: duplicate GTs at rows 1, 2, 4, 6 and 9, 12 (exact ties across rows).
    truths[2, [2, 4, 6]] = truths[2, 1]
    truths[2, 12] = truths[2, 9]
    # 3: two GTs with the same best prior, the later with the other label.
    truths[3, 5] = truths[3, 3] + np.float32(0.004)
    # 4: padded rows after a prefix of 5 (zeros, as batch_targets pads).
    valid[4, 5:] = False
    truths[4, 5:] = 0.0
    # 5: valid rows that are not a prefix, garbage in the invalid rows.
    valid[5] = rng.random(G) < 0.5
    valid[5, -1] = True
    # 6: no valid row.
    valid[6] = False
    # 7: a single valid row, the last one.
    valid[7, :-1] = False
    labels = rng.choice([1.0, -1.0], (b, G)).astype(np.float32)
    labels[3, 3], labels[3, 5] = 1.0, -1.0
    landms = rng.uniform(0, 1, (b, G, 10)).astype(np.float32)
    return truths, labels, landms, valid


@pytest.fixture(scope="module")
def problem():
    cfg = JC.get_model_config("jabd_flagship").anchors
    priors = JA.generate_anchors(cfg, (384, 384)).copy()
    assert priors.shape == (6048, 4)
    return (priors,) + tie_cases(priors)


def _jax_xla_front(truths, priors, labels, landms, valid, monkeypatch):
    """(best_truth_overlap, best_truth_idx, best_prior_idx) of the XLA
    `match_single`: its arguments to `finish_match`."""
    monkeypatch.setattr(JM, "finish_match", lambda *args: args[1:4])
    fn = jax.vmap(lambda t, l, lm, v: JM.match_single(THRESHOLD, t, priors, VAR, l, lm, v))
    out = fn(truths, labels, landms, valid)
    monkeypatch.undo()
    return [np.asarray(o) for o in out]


def test_front_half_equals_xla_and_pallas(problem, monkeypatch):
    priors, truths, labels, landms, valid = problem
    got = TM.match_front_plain(
        torch.from_numpy(truths), torch.from_numpy(priors), torch.from_numpy(valid)
    )
    got = [g.numpy() for g in got]
    assert got[1].dtype == np.int64 and got[2].dtype == np.int64
    xla = _jax_xla_front(
        jnp.asarray(truths), jnp.asarray(priors), jnp.asarray(labels),
        jnp.asarray(landms), jnp.asarray(valid), monkeypatch,
    )
    pallas = [
        np.asarray(o)
        for o in jax_match_front_pallas(
            jnp.asarray(truths), jnp.asarray(priors), jnp.asarray(valid), interpret=True
        )
    ]
    for name, g, x, p in zip(("best_truth_overlap", "best_truth_idx", "best_prior_idx"), got, xla, pallas):
        np.testing.assert_array_equal(g, x, err_msg=f"{name} vs XLA")
        np.testing.assert_array_equal(g, p, err_msg=f"{name} vs Pallas")
        # bit for bit, not only equal as values
        assert g.astype(g.dtype).tobytes() == np.ascontiguousarray(x).astype(g.dtype).tobytes(), name
    # The cases do what they claim.
    assert (got[0][1] == 1.0).sum() >= G  # GTs that are priors
    assert (got[0][6] == -1.0).all() and (got[1][6] == 0).all() and (got[2][6] == 0).all()
    assert got[2][3][3] == got[2][3][5]  # two GTs, one best prior
    assert (got[2][4][5:] == 0).all()  # padded rows


def _match(front, problem):
    priors, truths, labels, landms, valid = (torch.from_numpy(a) for a in problem)
    return TM.match_batch(THRESHOLD, truths, priors, VAR, labels, landms, valid, front=front)


@pytest.mark.parametrize("front", ["plain", "wrapper"])
def test_match_result_equals_xla_and_pallas(problem, front):
    fn = TM.match_front_plain if front == "plain" else matching_cuda.match_front
    before = matching_cuda.match_front.launches
    got = _match(fn, problem)
    assert matching_cuda.match_front.launches == before  # CPU tensors: no launch
    priors, truths, labels, landms, valid = (jnp.asarray(a) for a in problem)
    args = (THRESHOLD, truths, priors, VAR, labels, landms, valid)
    xla = JM.match_batch(*args)
    pallas = match_batch_pallas(*args, interpret=True)
    for want_name, want in (("XLA", xla), ("Pallas", pallas)):
        for f in ("conf_t", "box_t"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f"{f} vs {want_name}"
            )
        for f in ("loc_t", "landm_t"):
            # observed: loc_t max error 4.8e-7 on values up to 8.9 (the two
            # libraries' log rounds differently), landm_t exact; stated
            # tolerance 1e-6 plus 5e-7 of the value
            np.testing.assert_allclose(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                rtol=5e-7, atol=1e-6, err_msg=f"{f} vs {want_name}",
            )
    conf = got.conf_t.numpy()
    priors, truths, _, _, valid = (torch.from_numpy(a) for a in problem)
    shared = int(TM.match_front_plain(truths, priors, valid)[2][3, 3])
    assert conf[3, shared] == -1.0  # the shared prior went to the LAST GT (label -1)
    assert (conf[6] == 0).all()  # no valid GT: all background
    assert np.isfinite(got.loc_t.numpy()).all() and np.isfinite(got.landm_t.numpy()).all()


def test_forced_match_last_gt_wins():
    """The two-GT case of tests/test_matching.py: both GTs' best prior is
    prior 0, and prior 0 goes to GT 1."""
    priors = np.asarray([[0.5, 0.5, 0.2, 0.2], [0.9, 0.9, 0.1, 0.1]], np.float32)
    truths = np.asarray([[[0.42, 0.42, 0.58, 0.58], [0.45, 0.45, 0.62, 0.62]]], np.float32)
    labels = np.asarray([[1.0, -1.0]], np.float32)
    landms = np.zeros((1, 2, 10), np.float32)
    valid = np.ones((1, 2), bool)
    got = TM.match_batch(
        THRESHOLD, *(torch.from_numpy(a) for a in (truths, priors)), VAR,
        *(torch.from_numpy(a) for a in (labels, landms, valid)),
    )
    want = JM.match_batch(THRESHOLD, truths, priors, VAR, labels, landms, valid)
    np.testing.assert_array_equal(got.conf_t.numpy(), np.asarray(want.conf_t))
    assert got.conf_t[0, 0] == -1.0


TILE = 1024


def _prior_corners(priors):
    """The kernel's (and the plain version's) corner arithmetic."""
    return (priors[:, 0] - priors[:, 2] / 2, priors[:, 1] - priors[:, 3] / 2,
            priors[:, 0] + priors[:, 2] / 2, priors[:, 1] + priors[:, 3] / 2)


def _tile_boxes(priors):
    """Per 1024-prior tile, the bounding box (X1, Y1, X2, Y2) of its priors."""
    px1, py1, px2, py2 = _prior_corners(torch.from_numpy(priors))
    return [(float(px1[lo:lo + TILE].min()), float(py1[lo:lo + TILE].min()),
             float(px2[lo:lo + TILE].max()), float(py2[lo:lo + TILE].max()))
            for lo in range(0, len(priors), TILE)]


def _k2_emulation(truths, priors, valid):
    """`csrc/matching.cu`'s algorithm on the CPU."""
    truths, priors, valid = (torch.from_numpy(a) for a in (truths, priors, valid))
    bsz, g = valid.shape
    p = priors.shape[0]
    px1, py1, px2, py2 = _prior_corners(priors)
    parea = (px2 - px1) * (py2 - py1)
    tx1, ty1, tx2, ty2 = truths.unbind(-1)
    area_t = (tx2 - tx1) * (ty2 - ty1)
    bt_ov = torch.empty((bsz, p), dtype=torch.float32)
    bt_ix = torch.empty((bsz, p), dtype=torch.int64)
    ntiles = -(-p // TILE)
    tile_max = torch.full((bsz, ntiles, g), -1.0)
    tile_arg = torch.zeros((bsz, ntiles, g), dtype=torch.int64)
    for t in range(ntiles):
        sl = slice(t * TILE, min(p, (t + 1) * TILE))
        X1, Y1 = px1[sl].min(), py1[sl].min()
        X2, Y2 = px2[sl].max(), py2[sl].max()
        hit = (valid & (torch.minimum(tx2, X2) - torch.maximum(tx1, X1) > 0)
               & (torch.minimum(ty2, Y2) - torch.maximum(ty1, Y1) > 0))
        for b in range(bsz):
            rows = torch.nonzero(valid[b]).flatten().tolist()
            start = (0.0, rows[0]) if rows else (-1.0, 0)
            best = torch.full((sl.stop - sl.start,), start[0])
            idx = torch.full((sl.stop - sl.start,), start[1], dtype=torch.int64)
            for j in rows:
                if not hit[b, j]:  # +0 on every prior of the tile
                    tile_max[b, t, j], tile_arg[b, t, j] = 0.0, sl.start
                    continue
                iw = torch.clamp(torch.minimum(tx2[b, j], px2[sl]) - torch.maximum(tx1[b, j], px1[sl]), min=0.0)
                ih = torch.clamp(torch.minimum(ty2[b, j], py2[sl]) - torch.maximum(ty1[b, j], py1[sl]), min=0.0)
                inter = iw * ih
                iou = torch.where(inter == 0, 0.0, inter / ((area_t[b, j] + parea[sl]) - inter))
                better = iou > best
                best = torch.where(better, iou, best)
                idx = torch.where(better, j, idx)
                tile_max[b, t, j] = iou.max()
                tile_arg[b, t, j] = sl.start + torch.argmax(iou)  # the first maximum
            bt_ov[b, sl], bt_ix[b, sl] = best, idx
    first_tile = torch.argmax(tile_max, dim=1, keepdim=True)  # first tile on ties
    bp_ix = torch.where(valid, torch.gather(tile_arg, 1, first_tile)[:, 0], 0)
    return bt_ov, bt_ix, bp_ix


def _spread_case(priors, seed=1):
    """GT counts spread over 0..G per image (face-sized boxes)."""
    rng = np.random.default_rng(seed)
    b = 6
    truths = np.zeros((b, G, 4), np.float32)
    valid = np.zeros((b, G), bool)
    for i, n in enumerate(np.linspace(G, 0, b).round().astype(int)):
        cxy = rng.uniform(0.05, 0.95, (n, 2))
        wh = rng.uniform(0.01, 0.2, (n, 2))
        truths[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], 1), 0.0, 1.0)
        valid[i, :n] = True
    return truths, valid


def _edge_case(priors, seed=2):
    """Image 0: per tile, GTs whose edge lies exactly on an edge of the
    tile's box (iw or ih is 0 on that boundary: culled) and one a float
    step inside it (not culled); image 1: GTs covering the whole image;
    image 2: a single valid row, not row 0."""
    rng = np.random.default_rng(seed)
    g = 48
    truths = np.zeros((3, g, 4), np.float32)
    valid = np.zeros((3, g), bool)
    rows = []
    w = h = np.float32(0.1)
    for X1, Y1, X2, Y2 in np.asarray(_tile_boxes(priors), np.float32):
        x, y = rng.uniform(0.2, 0.6, 2).astype(np.float32)
        below, left = np.nextafter(Y2, np.float32(-2)), np.nextafter(X2, np.float32(-2))
        rows += [
            [x, Y2, x + w, Y2 + h],  # below the tile, touching
            [x, Y1 - h, x + w, Y1],  # above it
            [X2, y, X2 + w, y + h],  # right of it
            [X1 - w, y, X1, y + h],  # left of it
            [x, below, x + w, Y2 + h],  # overlapping by one float step
            [left, y, X2 + w, y + h],
        ]
    rows = np.asarray(rows, np.float32)[:g]
    truths[0, : len(rows)] = rows
    valid[0, : len(rows)] = True
    truths[1, :3] = [[0.0, 0.0, 1.0, 1.0], [0.3, 0.3, 0.4, 0.4], [0.0, 0.0, 1.0, 1.0]]
    valid[1, :3] = True
    truths[2] = np.clip(_random_boxes(rng, g), 0.0, 1.0)
    valid[2, 9] = True
    return truths, valid


def _case(problem, case):
    """(priors, truths, valid) of a named case."""
    priors = problem[0]
    if case == "ties":
        return priors, problem[1], problem[4]
    if case == "spread":
        return (priors,) + _spread_case(priors)
    return (priors,) + _edge_case(priors)


@pytest.mark.parametrize("case", ["ties", "spread", "tile_edges"])
def test_kernel_algorithm_equals_plain(problem, case):
    priors, truths, valid = _case(problem, case)
    got = _k2_emulation(truths, priors, valid)
    want = TM.match_front_plain(*(torch.from_numpy(a) for a in (truths, priors, valid)))
    for name, g, w in zip(("best_truth_overlap", "best_truth_idx", "best_prior_idx"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w), name


@pytest.mark.parametrize("case", ["ties", "spread", "tile_edges"])
def test_chip_smoke_operations_count_the_pairs_k2_visits(problem, case):
    """K2's operations bound in chip_smoke.py counts MATCH_FLOPS per (valid
    GT, prior) pair in a tile whose box the GT meets, as the kernel culls,
    and CULL_FLOPS per (valid GT, tile)."""
    import chip_smoke

    priors, truths, valid = _case(problem, case)
    t, v = torch.from_numpy(truths), torch.from_numpy(valid)
    pairs = 0
    boxes = _tile_boxes(priors)
    for i, (X1, Y1, X2, Y2) in enumerate(boxes):
        hit = (v & (torch.clamp(t[..., 2], max=X2) - torch.clamp(t[..., 0], min=X1) > 0)
               & (torch.clamp(t[..., 3], max=Y2) - torch.clamp(t[..., 1], min=Y1) > 0))
        pairs += int(hit.sum()) * (min(len(priors), (i + 1) * TILE) - i * TILE)
    assert 0 < pairs < int(v.sum()) * len(priors)  # culling leaves some pairs, not all
    want = chip_smoke.MATCH_FLOPS * pairs + chip_smoke.CULL_FLOPS * int(v.sum()) * len(boxes)
    assert chip_smoke.match_ops(t, v, torch.from_numpy(priors), TILE) == want


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.zeros((2, 4, 4))
    p = torch.zeros((8, 4))
    v = torch.ones((2, 4), dtype=torch.bool)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        matching_cuda.match_front(t.to(meta), p.to(meta), v.to(meta))
