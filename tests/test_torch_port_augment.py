"""PyTorch port, training input against the JAX package on the CPU: the
per-sample resample plans (`ops/resize.py`), the numpy PIL-bicubic resize
(`ops/image.py::pil_bicubic_resize`) against PIL itself, the cv2 HSV
conversions, the augmentation draws and box transform, `augment_sample`
(PIL + cv2 in the JAX package), `plan_sample` / `stack_plans` /
`device_augment` (`data/device_augment.py`), and both loaders over a
directory of PNGs.

Inputs are numpy-seeded, Gaussian-blurred noise (as in
tests/test_device_augment.py: white noise overstates resample-filter
differences that photos never show).
"""

import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jabd_tpu.data import device_augment as JDA
from jabd_tpu.data import wider as JW
from jabd_tpu.ops import resize as JR
from jabd_tpu.ops.image import preprocess_input_np
from jabd_tpu_torch.data import device_augment as TDA
from jabd_tpu_torch.data import wider as TW
from jabd_tpu_torch.ops import resize as TR
from jabd_tpu_torch.ops.image import hsv_to_rgb_cv2, pil_bicubic_resize, rgb_to_hsv_cv2
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)


def _smooth_image(rng, h, w):
    x = rng.integers(0, 255, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(x, (0, 0), 1.2)


def _sample_boxes(rng, iw, ih, n=6):
    box = np.zeros((n, 15), np.float32)
    cxy = np.stack([rng.uniform(5, iw - 5, n), rng.uniform(5, ih - 5, n)], -1)
    wh = np.stack([rng.uniform(4, 40, n), rng.uniform(4, 40, n)], -1)
    box[:, 0:2] = cxy - wh / 2
    box[:, 2:4] = cxy + wh / 2
    box[:, 4:14] = rng.uniform(0, min(iw, ih), (n, 10))
    box[:, 14] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    return box


# (in_size, out_len, offset, canvas, flip): up- and downscales, negative
# and overhanging pastes, the right-edge clip, a 1-px output at a downscale
# factor near TAPS_FSCAP.
AXIS_CASES = [
    (120, 300, -40, 128, False),
    (150, 37, 10, 128, True),
    (96, 96, 0, 96, False),
    (128, 200, 50, 128, True),
    (7, 1, 7, 64, False),
    (200, 64, -5, 64, True),
    (5, 90, 3, 100, False),
]


@pytest.mark.parametrize("case", AXIS_CASES)
def test_taps_and_matrices_equal_jax(case):
    in_size, out_len, offset, canvas, flip = case
    for a, b in zip(TR.pil_bicubic_taps(in_size, max(out_len, 1)), JR.pil_bicubic_taps(in_size, max(out_len, 1))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
        TR.paste_resize_matrix(in_size, out_len, offset, canvas, 256, flip=flip),
        JR.paste_resize_matrix(in_size, out_len, offset, canvas, 256, flip=flip),
    ):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
        TR.paste_resize_taps(in_size, out_len, offset, canvas, flip=flip),
        JR.paste_resize_taps(in_size, out_len, offset, canvas, flip=flip),
    ):
        np.testing.assert_array_equal(a, b)
    assert (TR.TAPS_FSCAP, TR.TAPS_K) == (JR.TAPS_FSCAP, JR.TAPS_K)


def test_expand_taps_rebuilds_the_dense_matrices():
    """expand_taps of the port's plan == the JAX package's dense plan
    matrices (paste_resize_matrix) over the draw distribution (flip,
    off-canvas pastes, right-edge clips, sources filling the bucket, whose
    trailing zero taps run past it), and == the JAX expand_taps."""
    s, bucket = 128, 160
    for seed in range(30):
        rng = np.random.default_rng(400 + seed)
        ih, iw = (160, 160) if seed % 5 == 0 else (120, 150)
        img = _smooth_image(rng, ih, iw)
        box0 = _sample_boxes(rng, iw, ih)
        _, dense, _ = JDA.plan_sample(img, box0.copy(), s, np.random.default_rng(seed), (bucket, bucket))
        _, taps, _ = TDA.plan_sample(img, box0.copy(), s, np.random.default_rng(seed), (bucket, bucket))
        mv, mh = dense[:2]
        xv, wv, xh, wh = taps[:4]
        for x, w, m in ((xv, wv, mv), (xh, wh, mh)):
            got = TR.expand_taps(torch.from_numpy(x[None].copy()), torch.from_numpy(w[None].copy()), bucket, torch.float32)
            np.testing.assert_array_equal(got[0].numpy(), m, err_msg=f"s{seed}")
            want = JR.expand_taps(jnp.asarray(x[None]), jnp.asarray(w[None]), bucket, jnp.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resample_canvas_matches_jax_highest():
    rng = np.random.default_rng(3)
    b, s, bucket = 2, 64, 96
    images = rng.integers(0, 256, (b, bucket, bucket, 3), np.uint8)
    mats = [
        [TR.paste_resize_matrix(90, int(rng.integers(20, 140)), int(rng.integers(-20, 30)), s, bucket, flip=bool(i))
         for i in range(b)]
        for _ in range(2)
    ]
    (mv, iv), (mh, ih_) = [tuple(np.stack(x) for x in zip(*axis)) for axis in mats]
    want = JR.resample_canvas(jnp.asarray(images), mv, mh, iv, ih_, 128.0, resample_dtype=jnp.float32)
    got = TR.resample_canvas(
        torch.from_numpy(images), torch.from_numpy(mv), torch.from_numpy(mh),
        torch.from_numpy(iv), torch.from_numpy(ih_), 128.0, resample_dtype=torch.float32,
    )
    assert got.shape == (b, s, s, 3) and got.dtype == torch.float32
    # observed max |difference| 0 (values are rounded grey levels); stated 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


# (source h, w, output w, h): up- and downscales, 1-px outputs, one axis
# unchanged, widths whose last taps hit the right edge, a large downscale.
RESIZE_CASES = [
    ((96, 128), (256, 192)),
    ((96, 128), (64, 48)),
    ((96, 128), (37, 111)),
    ((96, 128), (128, 96)),
    ((96, 128), (1, 1)),
    ((96, 128), (1, 200)),
    ((1, 1), (17, 9)),
    ((57, 61), (61, 300)),
    ((57, 61), (300, 57)),
    ((300, 503), (503, 97)),
    ((203, 301), (13, 29)),
    ((640, 480), (83, 64)),
]


@pytest.mark.parametrize("src_hw,size_wh", RESIZE_CASES)
def test_pil_bicubic_resize_is_pil_byte_for_byte(src_hw, size_wh):
    """Byte equality with PIL.Image.resize(BICUBIC) on noise (sharp edges
    overshoot and exercise the clip) and on smooth content."""
    rng = np.random.default_rng(sum(src_hw) + sum(size_wh))
    for img in (rng.integers(0, 256, src_hw + (3,), np.uint8), _smooth_image(rng, *src_hw)):
        want = np.asarray(Image.fromarray(img).resize(size_wh, Image.BICUBIC))
        got = pil_bicubic_resize(img, size_wh)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # A window of the output is the same window of the full resize.
    ow, oh = size_wh
    window = (ow // 3, oh // 4, max(ow // 3 + 1, ow - 2), max(oh // 4 + 1, oh - 1))
    x0, y0, x1, y1 = window
    np.testing.assert_array_equal(pil_bicubic_resize(img, size_wh, window), want[y0:y1, x0:x1])


def test_hsv_roundtrip_matches_cv2():
    """The bounds of tests/test_device_augment.py::test_hsv_roundtrip_matches_cv2."""
    rng = np.random.default_rng(1)
    rgb = rng.random((64, 64, 3), np.float64).astype(np.float32)
    ref_hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    ours_hsv = rgb_to_hsv_cv2(torch.from_numpy(rgb)).numpy()
    # observed 3.1e-5; stated 2e-4
    np.testing.assert_allclose(ours_hsv, ref_hsv, atol=2e-4)
    hsv = ref_hsv.copy()
    hsv[..., 1:] *= 0.9
    ref_rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    ours_rgb = hsv_to_rgb_cv2(torch.from_numpy(hsv)).numpy()
    # observed 4.2e-7; stated 1e-5
    np.testing.assert_allclose(ours_rgb, ref_rgb, atol=1e-5)
    # The same float operations as the JAX package's versions.
    np.testing.assert_array_equal(ours_rgb, np.asarray(JDA.hsv_to_rgb_cv2(jnp.asarray(hsv))))
    np.testing.assert_allclose(ours_hsv, np.asarray(JDA.rgb_to_hsv_cv2(jnp.asarray(rgb))), atol=1e-4)


def test_draws_and_box_transform_equal_jax():
    for seed in range(300):
        size = (64, 128, 840)[seed % 3]
        want = JW.draw_augment_params(np.random.default_rng(seed), size)
        got = TW.draw_augment_params(np.random.default_rng(seed), size)
        assert tuple(vars(got).values()) == tuple(vars(want).values()), seed
        rng = np.random.default_rng(10_000 + seed)
        iw, ih = int(rng.integers(20, 900)), int(rng.integers(20, 900))
        box = _sample_boxes(rng, iw, ih, n=int(rng.integers(0, 9)))
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got_b = TW.transform_boxes(box, got, (iw, ih), size, r_t)
        want_b = JW.transform_boxes(box, want, (iw, ih), size, r_j)
        assert got_b.dtype == want_b.dtype
        np.testing.assert_array_equal(got_b, want_b)
        assert r_t.random() == r_j.random()  # the same draws consumed


@pytest.mark.parametrize("size", [128, 64])
def test_augment_sample_matches_jax(size):
    """The port (numpy PIL resize, torch HSV) against the JAX package's
    (PIL, cv2): targets byte-identical; the canvas before the HSV jitter is
    identical, so frames differ by the HSV float arithmetic only."""
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        img = _smooth_image(rng, 120 + 30 * (seed % 3), 150)
        box0 = _sample_boxes(rng, 150, img.shape[0])
        want_img, want_box = JW.augment_sample(Image.fromarray(img), box0.copy(), size, np.random.default_rng(seed))
        got_img, got_box = TW.augment_sample(img, box0.copy(), size, np.random.default_rng(seed))
        np.testing.assert_array_equal(got_box, want_box, err_msg=f"s{seed}")
        assert got_img.dtype == np.float32 and got_img.shape == (size, size, 3)
        # observed max 1.4e-4 grey levels; stated 1e-3
        np.testing.assert_allclose(got_img, want_img, atol=1e-3, rtol=0, err_msg=f"s{seed}")


def test_plan_sample_and_stack_plans_equal_jax():
    """Same padded source (where it is read), plan parts and boxes, for
    sources inside the bucket and oversize ones that are pre-shrunk."""
    bucket = (128, 128)
    parts_t, parts_j = [], []
    for seed in range(8):
        rng = np.random.default_rng(300 + seed)
        ih, iw = ((300, 500), (120, 150), (128, 90), (700, 200))[seed % 4]
        img = _smooth_image(rng, ih, iw)
        box0 = _sample_boxes(rng, iw, ih)
        pt, pa_t, bt = TDA.plan_sample(img, box0.copy(), 96, np.random.default_rng(seed), bucket)
        pj, pa_j, bj = JDA.plan_sample(img, box0.copy(), 96, np.random.default_rng(seed), bucket, compact=True)
        np.testing.assert_array_equal(bt, bj)
        th, tw = min(ih, bucket[0]), min(iw, bucket[1])
        np.testing.assert_array_equal(pt[:th, :tw], pj[:th, :tw])  # the pre-shrink, byte for byte
        for a, b in zip(pa_t, pa_j):
            np.testing.assert_array_equal(a, b)
        parts_t.append(pa_t)
        parts_j.append(pa_j)
    plan_t = TDA.stack_plans(parts_t)
    plan_j = JDA.stack_plans(parts_j)
    assert type(plan_t).__name__ == type(plan_j).__name__
    assert plan_t._fields == plan_j._fields
    for a, b in zip(plan_t, plan_j):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
    # bf16 storage: torch's rounding is ml_dtypes' (nearest even).
    import ml_dtypes

    half_t = TDA.stack_plans(parts_t, weight_dtype=torch.bfloat16)
    half_j = JDA.stack_plans(parts_j, matrix_dtype=ml_dtypes.bfloat16)
    for name in ("w_v", "w_h"):
        got = getattr(half_t, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), getattr(half_j, name).astype(np.float32))


def _plan_batch(n=4, s=128, bucket=(160, 160)):
    padded, parts, host = [], [], []
    for seed in range(n):
        rng = np.random.default_rng(100 + seed)
        img = _smooth_image(rng, 120, 150)
        box0 = _sample_boxes(rng, 150, 120)
        p, pa, b = TDA.plan_sample(img, box0.copy(), s, np.random.default_rng(seed), bucket)
        hi, hb = TW.augment_sample(img, box0.copy(), s, np.random.default_rng(seed))
        np.testing.assert_array_equal(b, hb)
        padded.append(p)
        parts.append(pa)
        host.append(preprocess_input_np(hi))
    return np.stack(padded), parts, np.stack(host)


def _canvases(padded, plan, dtypes):
    """The resampled grey canvases before the HSV jitter, port and JAX."""
    tdt, jdt = dtypes
    bh, bw = padded.shape[1:3]
    mv = TR.expand_taps(plan.xmin_v, plan.w_v, bh, torch.float32)
    mh = TR.expand_taps(plan.xmin_h, plan.w_h, bw, torch.float32)
    args = (mv, mh, plan.inside_v, plan.inside_h)
    got = TR.resample_canvas(torch.from_numpy(padded), *args, 128.0, resample_dtype=tdt)
    want = JR.resample_canvas(jnp.asarray(padded), *(a.numpy() for a in args), 128.0, resample_dtype=jdt)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_device_augment_matches_jax_and_the_host(tdt, jdt):
    """Port against JAX, float32 and bf16 resample: the canvases agree but
    for values that the two matmuls' sum orders round to the other side of
    a .5 tie (1 grey level); the frames agree within 1e-3 on every pixel
    whose canvas agrees. Then, at float32, device against host."""
    padded, parts, host = _plan_batch()
    u8 = torch.from_numpy(padded)
    plan = TDA.stack_plans(parts)
    got = TDA.device_augment(u8, plan, resample_dtype=tdt)
    assert got.shape == (4, 128, 128, 3) and got.dtype == torch.float32
    want = np.asarray(JDA.device_augment(jnp.asarray(padded), JDA.stack_plans(parts), resample_dtype=jdt))
    c_got, c_want = _canvases(padded, plan, (tdt, jdt))
    diff = np.abs(c_got - c_want)
    # observed: 1 of 196,608 canvas values (float32), none (bf16)
    assert set(np.unique(diff)) <= {0.0, 1.0} and (diff > 0).mean() <= 1e-4
    same = ~(diff > 0).any(-1)
    # observed max 4.6e-5 (float32), 6.1e-5 (bf16); stated 1e-3
    np.testing.assert_allclose(got.numpy()[same], want[same], atol=1e-3, rtol=0)
    if tdt != torch.float32:
        return
    # Device against host: the bounds of
    # tests/test_device_augment.py::test_boxes_byte_identical_and_pixels_close.
    for i in range(len(host)):
        err = np.abs(got[i].numpy() - host[i])
        assert (err.max(-1) > 6.0).mean() <= 0.005, i
        assert err.mean() <= 0.5, i


def test_bfloat16_resample_close_to_f32():
    """The input and bounds of
    tests/test_device_augment.py::test_bfloat16_resample_close_to_f32."""
    rng = np.random.default_rng(7)
    img = _smooth_image(rng, 100, 90)
    box0 = _sample_boxes(rng, 90, 100)
    padded, parts, _ = TDA.plan_sample(img, box0, 128, np.random.default_rng(3), (128, 128))
    plan = TDA.stack_plans([parts])
    u8 = torch.from_numpy(padded[None])
    f32 = TDA.device_augment(u8, plan, torch.float32).numpy()
    bf16 = TDA.device_augment(u8, plan, torch.bfloat16).numpy()
    assert np.abs(f32 - bf16).max() <= 6.0
    assert np.abs(f32 - bf16).mean() <= 0.5


def _png_dataset(tmp_path, n=6):
    root = tmp_path / "train"
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        h, w = (70 + 13 * i, 90 + 31 * (i % 3))
        Image.fromarray(_smooth_image(rng, h, w)).save(root / "images" / f"i{i}.png")
        lines.append(f"# i{i}.png")
        for _ in range(1 + i % 3):
            x, y = rng.uniform(5, 40, 2)
            lm = " ".join(f"{x + 3 * p:.1f} {y + 2:.1f} 0.0" for p in range(5))
            lines.append(f"{x:.1f} {y:.1f} {rng.uniform(8, 30):.1f} {rng.uniform(8, 30):.1f} {lm} 0.9")
    (root / "label.txt").write_text("\n".join(lines) + "\n")
    return str(root / "label.txt")


def test_both_loaders_give_the_jax_targets(tmp_path):
    """A directory of PNGs through the port's host and device loaders and
    the JAX package's: identical targets for the same seed; host frames
    within the HSV arithmetic of the JAX package's; device sources
    identical where read."""
    label = _png_dataset(tmp_path)
    tds = TW.WiderFaceDataset(label, input_size=64)
    jds = JW.WiderFaceDataset(label, input_size=64)
    kw = dict(batch_size=2, max_targets=8, seed=3, num_workers=2)
    host_t = list(TW.train_loader(tds, **kw))
    host_j = list(JW.train_loader(jds, **kw))
    dev_t = list(TDA.device_train_loader(tds, bucket_hw=(128, 128), **kw))
    dev_j = list(JDA.device_train_loader(jds, bucket_hw=(128, 128), **kw))
    assert len(host_t) == len(host_j) == len(dev_t) == len(dev_j) == 3
    for (hi, ht), (hj, htj), (di, plan, dt), (dj, planj, dtj) in zip(host_t, host_j, dev_t, dev_j):
        for a, b, c, d in zip(ht, htj, dt, dtj):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)
            np.testing.assert_array_equal(d, b)
        np.testing.assert_allclose(hi, hj, atol=1e-3, rtol=0)
        assert isinstance(plan, TDA.AugmentPlanTaps) and plan.w_v.dtype == torch.bfloat16
        assert di.shape == (2, 128, 128, 3) and di.dtype == np.uint8
        frames = TDA.device_augment(torch.from_numpy(di), plan)
        want = JDA.device_augment(jnp.asarray(dj), planj)
        # observed max 6.1e-5; stated 1e-3 (margins differ: np.empty)
        np.testing.assert_allclose(frames.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_load_image_needs_pil(tmp_path, monkeypatch):
    """On a machine without PIL the dataset cannot decode, and says so."""
    ds = TW.WiderFaceDataset(_png_dataset(tmp_path, n=1), input_size=64)
    assert ds.load_image(0).dtype == np.uint8
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        ds.load_image(0)
