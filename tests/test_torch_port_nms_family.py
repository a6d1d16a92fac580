"""PyTorch port, the rest of the NMS family of `jabd_tpu/ops/nms.py`:
`nms` (and its kernel twin `nms_cuda.nms`, which on CPU tensors runs the
plain loop), `soft_nms`, `topk_candidates` and `nms_numpy`, against the
JAX functions on the same inputs, and `nms_pallas(interpret=True)` against
the port's plain `nms`. Indices and masks must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.ops import nms as JN
from jabd_tpu.ops import nms_pallas as JNP
from jabd_tpu_torch.ops import nms as TN
from jabd_tpu_torch.ops import nms_cuda
from tests._torch_port_steps import one_torch_thread  # noqa: F401


def _case(rng, n, ties):
    """n boxes in clusters (so NMS suppresses), scores with exact ties
    when `ties`, a random valid mask."""
    centres = rng.uniform(0.1, 0.9, (max(n // 6, 1), 2))
    c = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 0.01, (n, 2))
    wh = rng.uniform(0.02, 0.15, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[: n // 10] = boxes[0]  # duplicates: metrics exactly 1
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores[::3] = 0.5
        scores[1::7] = 0.25
    valid = rng.random(n) < 0.8
    return boxes, scores, valid


@pytest.mark.parametrize("kind,thr", [("iou", 0.3), ("iou", 0.45), ("diou", 0.3), ("diou", -0.1)])
@pytest.mark.parametrize("n,max_out,ties", [(300, 750, True), (257, 40, False), (1, 5, False)])
def test_nms_matches_jax(rng, kind, thr, n, max_out, ties):
    boxes, scores, valid = _case(rng, n, ties)
    want_idx, want_valid = JN.nms(
        jnp.asarray(boxes), jnp.asarray(scores), thr, max_out, jnp.asarray(valid), kind
    )
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out, torch.from_numpy(valid), kind)
    for fn in (TN.nms, nms_cuda.nms):
        idx, ok = fn(*args)
        assert idx.shape == (max_out,) and ok.shape == (max_out,)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert ok.any()


def test_nms_without_valid_mask_matches_jax(rng):
    boxes, scores, _ = _case(rng, 200, True)
    want_idx, want_valid = JN.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 100)
    idx, ok = TN.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 100)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("kind", ["iou", "diou"])
def test_nms_pallas_interpret_matches_port(rng, kind):
    """The Pallas kernel's third entry point in interpret mode against the
    port's plain nms: the function K1 serves through nms_cuda.nms."""
    boxes, scores, valid = _case(rng, 130, True)
    want_idx, want_valid = JNP.nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.3, 64, jnp.asarray(valid), kind, interpret=True
    )
    idx, ok = TN.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 64, torch.from_numpy(valid), kind)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("sigma,thr,max_out", [(0.5, 0.001, 750), (0.3, 0.2, 60), (1.0, 0.5, 10)])
@pytest.mark.parametrize("ties", [False, True])
def test_soft_nms_matches_jax(rng, sigma, thr, max_out, ties):
    boxes, scores, valid = _case(rng, 150, ties)
    want = JN.soft_nms(jnp.asarray(boxes), jnp.asarray(scores), sigma, thr, max_out, jnp.asarray(valid))
    got = TN.soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores), sigma, thr, max_out, torch.from_numpy(valid))
    w_idx, w_sc, w_ok = (np.asarray(a) for a in want)
    g_idx, g_sc, g_ok = (a.numpy() for a in got)
    np.testing.assert_array_equal(g_ok, w_ok)
    np.testing.assert_array_equal(g_idx[g_ok], w_idx[w_ok])
    assert g_ok.any()
    # observed max error 6e-8 (exp in XLA and ATen)
    np.testing.assert_allclose(g_sc, w_sc, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,thr", [(50, 0.0), (120, 0.4), (200, 0.9)])
def test_topk_candidates_matches_jax(rng, k, thr):
    boxes, scores, _ = _case(rng, 200, True)
    want = JN.topk_candidates(jnp.asarray(boxes), jnp.asarray(scores), k, thr)
    got = TN.topk_candidates(torch.from_numpy(boxes), torch.from_numpy(scores), k, thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind,beta1", [("iou", 1.0), ("diou", 1.0), ("diou", 0.6)])
def test_nms_numpy_is_a_copy_of_jax(rng, kind, beta1):
    boxes, scores, _ = _case(rng, 400, True)
    boxes = boxes.astype(np.float64) * 640.0
    for thr in (0.3, 0.45):
        np.testing.assert_array_equal(
            TN.nms_numpy(boxes, scores, thr, kind, beta1), JN.nms_numpy(boxes, scores, thr, kind, beta1)
        )
    assert len(TN.nms_numpy(np.zeros((0, 4)), np.zeros(0))) == 0
