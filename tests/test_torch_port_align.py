"""PyTorch port, the ArcFace alignment (recognition/align.py) against the
JAX package's (Umeyama in numpy, warp by cv2.warpAffine), on seeded
scenes with landmarks partly off the image, rotations up to +-90 degrees
and crop sizes 112 and 56:

- `similarity_transform` equal within 1e-6, and its stacked form equal
  to JAX's per-face calls bit for bit;
- the warp: byte-equal to cv2 at 112 (a multiple of OpenCV's SIMD row
  width), within 1 grey level at 56, where OpenCV's scalar loop warps the
  last 8 pixels of each row (observed: 37 of 7,056,000 values differ);
- `align_from_detections` with N = 0 and with more faces than one gather
  chunk.
"""

import numpy as np
import pytest

from jabd_tpu.recognition import align as JA
from jabd_tpu_torch.recognition import align as TA


def _faces(rng, n, h=200, w=260):
    """n detection rows whose landmarks are the template under a random
    rotation (+-90 deg), scale and shift, some partly off the image."""
    rows = []
    for _ in range(n):
        ang = rng.uniform(-np.pi / 2, np.pi / 2)
        sc = rng.uniform(0.3, 2.0)
        t = rng.uniform(-40, max(h, w) - 20, 2)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]) * sc
        lmk = (TA.ARCFACE_TEMPLATE @ rot.T + t).astype(np.float32)
        rows.append(np.concatenate([np.zeros(5, np.float32), lmk.ravel()]))
    return np.stack(rows)


def test_similarity_transform_matches_jax(rng):
    for _ in range(50):
        src = rng.uniform(-50, 300, (5, 2)).astype(np.float32)
        dst = TA.ARCFACE_TEMPLATE * rng.uniform(0.5, 2)
        np.testing.assert_allclose(TA.similarity_transform(src, dst), JA.similarity_transform(src, dst),
                                   rtol=0, atol=1e-6)


def test_similarity_transform_stacked_equals_each(rng):
    """The stacked form align_from_detections uses gives each face's matrix
    bit for bit as the JAX package's one-at-a-time call does, degenerate
    point sets (all points equal, a reflection) included."""
    src = rng.uniform(-50, 600, (40, 5, 2)).astype(np.float32)
    src[:3] = src[:3, :1]
    src[3:6, :, 0] *= -1
    want = np.stack([JA.similarity_transform(s, TA.ARCFACE_TEMPLATE) for s in src])
    np.testing.assert_array_equal(TA.similarity_transform(src, TA.ARCFACE_TEMPLATE), want)


@pytest.mark.parametrize("size", [112, 56])
def test_align_matches_cv2(size, rng):
    n_diff = n_total = 0
    for _ in range(15):
        img = rng.integers(0, 256, (200, 260, 3), dtype=np.uint8)
        dets = _faces(rng, 5)
        got = TA.align_from_detections(img, dets, size)
        want = JA.align_from_detections(img, dets, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - want)
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
        n_total += d.size
        np.testing.assert_array_equal(TA.align_face(img, dets[0, 5:].reshape(5, 2), size), got[0])
    if size == 112:
        assert n_diff == 0
    else:
        assert n_diff / n_total < 1e-4, (n_diff, n_total)


def test_align_from_detections_empty_and_chunked(rng):
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    empty = TA.align_from_detections(img, np.zeros((0, 15), np.float32))
    assert empty.shape == (0, 112, 112, 3) and empty.dtype == np.uint8
    dets = _faces(rng, TA._CHUNK["cpu"] + 3, 120, 160)
    np.testing.assert_array_equal(TA.align_from_detections(img, dets), JA.align_from_detections(img, dets))
