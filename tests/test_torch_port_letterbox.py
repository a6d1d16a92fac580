"""PyTorch port, the batched device letterbox and the image pyramid:
`resample_canvas` on a rectangular canvas, the cv2 taps functions (copies,
equal to the JAX package's arrays), `plan_letterbox` (taps that expand to
the JAX package's dense matrices) + `upload_to_bucket` +
`letterbox_batch_device` (bit for bit the dense recipe it replaced),
`plan_pyramid` + `pyramid_batch_device` and the
cv2-free float32 INTER_CUBIC resize, each against the JAX package on the
same inputs and against the host recipes (cv2) under the JAX tests'
bounds (tests/test_letterbox_batch.py)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.ops import image as JI
from jabd_tpu.ops import resize as JR
from jabd_tpu_torch.ops import image as TI
from jabd_tpu_torch.ops import resize as TR
from tests._torch_port_steps import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _smooth(rng, h, w):
    x = rng.integers(0, 255, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(x, (0, 0), 1.2)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_resample_canvas_rectangular_canvas_matches_jax(rng, dtype):
    """th != tw: [B, 32, 64] rows and [B, 48, 96] columns give
    [B, 32, 48, 3] (a square canvas was assumed before: view(b, s, s, c)
    raised)."""
    jdt, tdt = DTYPES[dtype]
    b, th, tw, bh, bw = 2, 32, 48, 64, 96
    src = rng.integers(0, 256, (b, bh, bw, 3), dtype=np.uint8)
    # Per-sample PIL-bicubic plans (negative lobes, so the clip between
    # the passes matters), one flipped, one cropped by a negative offset.
    mv = np.stack([TR.paste_resize_matrix(bh, n, o, th, bh)[0] for n, o in ((30, 1), (40, -4))])
    mh = np.stack([TR.paste_resize_matrix(bw, n, o, tw, bw, flip=f)[0] for n, o, f in ((50, -2, True), (47, 0, False))])
    iv = (rng.random((b, th)) < 0.8).astype(np.float32)
    ih = (rng.random((b, tw)) < 0.8).astype(np.float32)
    want = np.asarray(JR.resample_canvas(*(jnp.asarray(a) for a in (src, mv, mh, iv, ih)), 84.0, jdt))
    got = TR.resample_canvas(*_t(src, mv, mh, iv, ih), 84.0, tdt).numpy()
    assert got.shape == want.shape == (b, th, tw, 3)
    err = np.abs(got - want)
    # Whole grey levels on both sides; observed max error 0.0 at both
    # dtypes (seeds 0-4). Stated: 1 grey level on at most 0.1% of values.
    assert err.max() <= 1.0 and (err > 0).mean() < 1e-3, (err.max(), (err > 0).mean())


@pytest.mark.parametrize("in_size,out_size", [(80, 50), (80, 211), (100, 100), (7, 5), (1, 9), (53, 13)])
def test_cv2_taps_are_copies_of_jax(in_size, out_size):
    for name in ("cv2_bilinear_taps", "cv2_cubic_taps"):
        for got, want in zip(getattr(TR, name)(in_size, out_size), getattr(JR, name)(in_size, out_size)):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    t = np.linspace(0, 1, 17, endpoint=False)
    np.testing.assert_array_equal(TR._cubic_weights(t), JR._cubic_weights(t))


@pytest.mark.parametrize(
    "args", [(123, 92, 80, 40, 160, 16), (211, 263, 160, 0, 160, 16), (401, 200, 160, 0, 160, 16), (77, 38, 30, 65, 160, 16)]
)
def test_compose_scale_letterbox_taps_is_a_copy_of_jax(args):
    for got, want in zip(TR.compose_scale_letterbox_taps(*args), JR.compose_scale_letterbox_taps(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _jax_letterbox(padded, parts, jdt):
    return np.asarray(
        JI.letterbox_batch_device(*(jnp.asarray(a) for a in (padded,) + tuple(parts)), resample_dtype=jdt)
    )


def _dense(plan, bucket):
    """A taps-form plan's (mv, mh, inside_v, inside_h), mv and mh expanded
    into float32 dense matrices on the CPU."""
    xv, wv, iv, xh, wh, ih = plan
    mv, mh = (TR.expand_taps(*_t(x[None], w[None]), n, torch.float32)[0].numpy()
              for x, w, n in ((xv, wv, bucket[0]), (xh, wh, bucket[1])))
    return mv, mh, iv, ih


def _device_letterbox(sources, plans, bucket, dtype):
    """The port's recipe: the sources' own bytes in a bucket made with
    `upload_to_bucket`, the stacked taps, `letterbox_batch_device`."""
    src = TI.upload_to_bucket(sources, bucket, "cpu")
    return TI.letterbox_batch_device(src, *_t(*(np.stack(p) for p in zip(*plans))), resample_dtype=dtype)


def parent_letterbox(images, target, bucket, letterbox=True, dtype=torch.bfloat16):
    """The dense recipe the taps replaced: per image `paste_resize_matrix`
    with cv2's bilinear taps, the sources padded to the bucket on the host
    and stacked, `resample_canvas`, the means. Sources within the bucket."""
    mats = []
    for im in images:
        ih, iw = im.shape[:2]
        if letterbox:
            _, nh, nw, top, left = TI.letterbox_params((ih, iw), target)
        else:
            nh, nw, top, left = target[0], target[1], 0, 0
        mv, iv = TR.paste_resize_matrix(ih, nh, top, target[0], bucket[0], taps=TR.cv2_bilinear_taps)
        mh, ihm = TR.paste_resize_matrix(iw, nw, left, target[1], bucket[1], taps=TR.cv2_bilinear_taps)
        mats.append((mv, mh, iv, ihm))
    padded = np.stack([TI.pad_to_bucket(im, bucket) for im in images])
    y = TR.resample_canvas(*_t(padded, *(np.stack(m) for m in zip(*mats))), TI.LETTERBOX_FILL, dtype)
    return y - torch.tensor(TI.MEANS)


# (source [h, w], target, bucket, letterbox): the cells' 3:4 image (1365 x
# 1024 in a 1408 x 1024 bucket at 1280), a 1 x 1 source, a source over the
# bucket (pre-shrunk), a plain resize, a wide and a tall source.
PLAN_CASES = {
    "cells_3x4_at_1280": ((1365, 1024), (1280, 1280), (1408, 1024), True),
    "one_pixel": ((1, 1), (64, 80), (128, 128), True),
    "over_the_bucket": ((300, 500), (128, 128), (256, 256), True),
    "no_letterbox": ((90, 70), (64, 80), (128, 128), False),
    "wide": ((96, 200), (96, 112), (256, 256), True),
    "tall": ((200, 40), (96, 112), (256, 256), True),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_letterbox_expands_to_the_jax_matrices(case):
    """Taps of two weights a row; expanded in float32 they equal the JAX
    package's dense plan arrays; the source is the image's own bytes (or
    its pre-shrink, a grey level from cv2's)."""
    shape, target, bucket, letterbox = PLAN_CASES[case]
    img = _smooth(np.random.default_rng(7), *shape) if min(shape) > 1 else np.full((*shape, 3), 201, np.uint8)
    source, plan = TI.plan_letterbox(img, target, bucket, letterbox)
    jpadded, jparts = JI.plan_letterbox(img, target, bucket, letterbox)
    xv, wv, iv, xh, wh, ih = plan
    assert xv.dtype == xh.dtype == np.int32 and wv.shape == (target[0], 2) and wh.shape == (target[1], 2)
    assert wv.dtype == wh.dtype == iv.dtype == ih.dtype == np.float32
    for got, want in zip(_dense(plan, bucket), jparts):
        np.testing.assert_array_equal(got, want)
    assert source.dtype == np.uint8 and source.flags.c_contiguous
    h, w = source.shape[:2]
    if case == "over_the_bucket":
        assert (h, w) == (153, 256)
        assert np.abs(source.astype(int) - jpadded[:h, :w]).max() <= 1
    else:
        assert source.shape == img.shape
        np.testing.assert_array_equal(source, img)
        np.testing.assert_array_equal(jpadded[:h, :w], img)


def test_upload_to_bucket_copies_each_image_into_its_corner():
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((5, 7), (8, 3), (1, 1))]
    bucket = TI.upload_to_bucket(imgs, (8, 8), "cpu")
    assert bucket.shape == (3, 8, 8, 3) and bucket.dtype == torch.uint8
    for row, im in zip(bucket, imgs):
        np.testing.assert_array_equal(row[: im.shape[0], : im.shape[1]].numpy(), im)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_letterbox_batch_equals_the_dense_recipe_bit_for_bit(dtype):
    """The cells' batch (1024 wide, 4:3, 3:2, 16:9, 3:4, two each) a
    quarter the size, at a 320 target: the taps expanded on the device over
    the images' own bytes give the frames of the dense matrices over the
    host-padded stack, to the bit."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(9)
    imgs = [_smooth(rng, 256 * b // a, 256) for a, b in ((4, 3), (3, 2), (16, 9), (3, 4)) for _ in range(2)]
    target = (320, 320)
    bucket = (-(-max(im.shape[0] for im in imgs) // 128) * 128, 256)
    sources, plans = zip(*(TI.plan_letterbox(im, target, bucket) for im in imgs))
    got = _device_letterbox(sources, plans, bucket, tdt)
    want = parent_letterbox(imgs, target, bucket, dtype=tdt)
    assert got.shape == (8, 320, 320, 3) and bucket == (384, 256)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_letterbox_batch_matches_jax_and_host(dtype):
    """One batch of four source sizes (two over the target, two under,
    one taller than wide) in one bucket, at a rectangular target."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    target, bucket = (96, 112), (256, 256)
    imgs = [_smooth(rng, *hw) for hw in ((96, 128), (128, 96), (64, 64), (200, 40))]
    sources, plans = zip(*(TI.plan_letterbox(im, target, bucket) for im in imgs))
    jplanned = [JI.plan_letterbox(im, target, bucket) for im in imgs]
    for im, source, plan, (jpadded, jparts) in zip(imgs, sources, plans, jplanned):
        ih, iw = im.shape[:2]
        np.testing.assert_array_equal(source, jpadded[:ih, :iw])
        for got, want in zip(_dense(plan, bucket), jparts):
            np.testing.assert_array_equal(got, want)
    padded = np.stack([p for p, _ in jplanned])
    parts = [np.stack(p) for p in zip(*(q for _, q in jplanned))]
    got = _device_letterbox(sources, plans, bucket, tdt).numpy()
    want = _jax_letterbox(padded, parts, jdt)
    assert got.shape == (4, 96, 112, 3) and got.dtype == np.float32
    err = np.abs(got - want)
    # Whole grey levels on both sides: observed max error 1.0 on 0.07% of
    # values at float32, 0.0 at bfloat16.
    assert err.max() <= 1.0 and (err > 0).mean() < 1e-3, (err.max(), (err > 0).mean())
    if dtype == "float32":
        # Before the rounding the two agree within 1e-3: every value they
        # round apart lies within 1e-3 of a .5 boundary (float64 sums).
        x = np.einsum("brh,bhwc->brwc", parts[0].astype(np.float64), padded.astype(np.float64))
        exact = np.einsum("bow,brwc->broc", parts[1].astype(np.float64), np.clip(x, 0, 255))
        frac = exact[err > 0] % 1.0
        assert np.abs(frac - 0.5).max() < 1e-3, np.abs(frac - 0.5).max()
    for i, im in enumerate(imgs):
        host = JI.preprocess_input_np(JI.letterbox_np(im, (target[1], target[0])))
        e = np.abs(got[i] - host)
        assert e.mean() <= 0.5, (i, e.mean())
        assert (e.max(-1) > 4).mean() <= 0.005, i


def test_oversize_source_pre_shrinks_within_a_grey_level():
    """A source over the bucket is shrunk first: here with torch bilinear
    (`resize_np`), in the JAX package with cv2 INTER_LINEAR."""
    rng = np.random.default_rng(2)
    img = _smooth(rng, 300, 500)
    source, plan = TI.plan_letterbox(img, (128, 128), (256, 256))
    jpadded, jparts = JI.plan_letterbox(img, (128, 128), (256, 256))
    assert source.shape == (153, 256, 3)  # the shrunk source's size
    for got, want in zip(_dense(plan, (256, 256)), jparts):
        np.testing.assert_array_equal(got, want)
    assert np.abs(source.astype(int) - jpadded[:153, :256]).max() <= 1
    got = _device_letterbox([source], [plan], (256, 256), torch.float32)
    want = _jax_letterbox(jpadded[None], [p[None] for p in jparts], jnp.float32)
    # observed max error 1.0 (a grey level of the pre-shrink, resampled)
    assert np.abs(got.numpy() - want).max() <= 2.0


def test_letterbox_without_letterbox_is_a_plain_resize():
    rng = np.random.default_rng(3)
    img = _smooth(rng, 90, 70)
    source, plan = TI.plan_letterbox(img, (64, 80), (128, 128), letterbox=False)
    got = _device_letterbox([source], [plan], (128, 128), torch.float32)
    host = JI.preprocess_input_np(cv2.resize(img, (80, 64)).astype(np.float32))
    assert np.abs(got[0].numpy() - host).max() <= 2.0


@pytest.mark.parametrize("shape,scale", [((123, 211), 0.75), ((123, 211), 1.25), ((300, 180), 1.0), ((77, 401), 0.5)])
def test_plan_pyramid_matches_jax_and_host(shape, scale):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    th, tw = 160, 160
    plan, size = TI.plan_pyramid(shape, scale, (th, tw))
    jplan, jsize = JI.plan_pyramid(shape, scale, (th, tw))
    assert size == jsize
    for got, want in zip(plan, jplan):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    padded = TI.pad_to_bucket(img, (384, 448))
    np.testing.assert_array_equal(padded[: shape[0], : shape[1]], img)
    got = TI.pyramid_batch_device(*_t(padded[None], *(p[None] for p in plan)))[0].numpy()
    want = np.asarray(JI.pyramid_batch_device(jnp.asarray(padded[None]), *(jnp.asarray(p[None]) for p in plan))[0])
    # observed max error 3.1e-5 (float32 association); host 7.7e-5
    assert np.abs(got - want).max() < 1e-3
    sh, sw = size
    scaled = cv2.resize(img.astype(np.float32), (sw, sh), interpolation=cv2.INTER_CUBIC)
    host = JI.preprocess_input_np(JI.letterbox_np(scaled, (tw, th)))
    assert np.abs(got - host).max() < 0.05


def test_zero_pyramid_plan_is_the_fill():
    rng = np.random.default_rng(6)
    src = torch.from_numpy(rng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8))
    z = torch.zeros((1, 64), dtype=torch.int32)
    zf = torch.zeros((1, 64))
    zw = torch.zeros((1, 64, TI.PYRAMID_TAPS_K))
    out = TI.pyramid_batch_device(src, z, zw, zf, z, zw, zf).numpy()
    expect = TI.LETTERBOX_FILL - np.asarray(TI.MEANS, np.float32)
    np.testing.assert_array_equal(out, np.broadcast_to(expect, out.shape))


@pytest.mark.parametrize("wh", [(29, 61), (96, 48), (53, 37), (13, 7), (80, 120)])
def test_cubic_resize_matches_cv2(rng, wh):
    """cv2.resize INTER_CUBIC on float32, overshoot included."""
    img = rng.uniform(0, 255, (37, 53, 3)).astype(np.float32)
    img[5:9, 10:20] = 255.0  # a sharp edge: the cubic overshoots past 255
    want = cv2.resize(img, wh, interpolation=cv2.INTER_CUBIC)
    got = TI.cubic_resize_np(img, wh)
    assert got.shape == want.shape and got.dtype == np.float32
    # observed max error 7.7e-5 on values up to 305
    assert np.abs(got - want).max() < 2e-3
    u8 = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
    want = cv2.resize(u8.astype(np.float32), wh, interpolation=cv2.INTER_CUBIC)
    assert np.abs(TI.cubic_resize_np(u8, wh) - want).max() < 2e-3
