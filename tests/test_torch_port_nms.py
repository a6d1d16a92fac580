"""PyTorch port, greedy NMS: the plain version (the oracle of the CUDA
kernel) gives keep masks EQUAL to the JAX package's XLA NMS and to its
Pallas kernel in interpret mode; the wrapper's CPU dispatch. The CUDA
kernel itself is held against the plain version on the card by
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
