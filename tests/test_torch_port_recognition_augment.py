"""PyTorch port, the recognition training augmentation (recognition/data.py,
recognition/device_augment.py) against the JAX package, on the CPU:

- the draws (`draw_face_augment_params`) are identical, RNG state after
  them included;
- `color_jitter_pil` is byte-equal to the JAX package's and to
  PIL.ImageEnhance;
- all 900 `cv2_resize_matrix` operators the draw can produce (5 modes x
  small sides 22..111 x down and up) lie within 1e-5 of JAX's, which
  resizes an identity matrix with cv2 (observed maximum per mode below);
- `augment_face` against JAX's host path: byte-exact without a low-res
  draw; with one, within the bound the JAX package holds its own device
  path to (mean < 3 LSB, p99 <= 8 LSB), the error recorded per mode;
- `device_augment_faces` at float32 against JAX's (equal without a
  low-res draw, but where JAX's float32 blend truncates 1 LSB off the
  host's float64 arithmetic; with one, <= 1 LSB before the jitter, which
  may stretch it to 4) and against the port's
  own host path (byte-exact without a low-res draw; the bound above with
  one);
- the contrast anchor: exact against the host's int(mean + 0.5) over a
  sweep of grey sums, where a float32 mean misses a near-tie at 512x512;
- `low_res_augmentation` against JAX's: the same draws, the image within
  the host low-res bound;
- both loaders over an ImageFolder of PNGs against JAX's: order, labels,
  plans, and per sample images byte-equal without a low-res draw (host
  against JAX, device against host), within the host bound with one; an
  off-size source resized within 1 grey level of cv2.
"""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance

from jabd_tpu.recognition import data as JD
from jabd_tpu.recognition import device_augment as JFDA
from jabd_tpu_torch.recognition import data as D
from jabd_tpu_torch.recognition import device_augment as FDA
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_recognition_device_augment import _rand_face

LSB = 2 / 255  # one grey level on the [-1, 1] scale
SIZE = 112
MODES = {0: "NEAREST", 1: "LINEAR", 2: "CUBIC", 3: "AREA", 4: "LANCZOS4"}


def test_draws_identical():
    for seed, probs in itertools.product(range(60), [(0.2, 0.2, 0.2), (0.9, 0.9, 0.9), (0.0, 1.0, 0.5)]):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = D.draw_face_augment_params(a, SIZE, SIZE, *probs)
        want = JD.draw_face_augment_params(b, SIZE, SIZE, *probs)
        assert tuple(got) == tuple(want)
        assert a.random() == b.random()  # the same RNG consumption
    assert D.CV2_INTERPS == JD.CV2_INTERPS


def test_color_jitter_byte_equal_to_jax_and_pil():
    rng = np.random.default_rng(11)
    for _ in range(3):
        img = _rand_face(rng)
        for order in itertools.permutations((0, 1, 2)):
            f = tuple(float(x) for x in rng.uniform(0.5, 1.5, 3))
            want = Image.fromarray(img, "RGB")
            for op in order:
                enhance = (ImageEnhance.Brightness, ImageEnhance.Contrast, ImageEnhance.Color)[op]
                want = enhance(want).enhance(f[op])
            got = D.color_jitter_pil(img, f, order)
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(order))
            np.testing.assert_array_equal(got, JD.color_jitter_pil(img, f, order))


@pytest.mark.parametrize("interp", sorted(MODES))
def test_cv2_resize_matrices_match_jax(interp):
    """Observed maxima: NEAREST, LINEAR, AREA 0; CUBIC 1.2e-7; LANCZOS4
    2.4e-7 (float32 summation order)."""
    worst = 0.0
    for small in range(22, 112):
        for a, b in ((SIZE, small), (small, SIZE)):
            got = FDA.cv2_resize_matrix(a, b, interp)
            assert got.shape == (b, a) and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - JFDA.cv2_resize_matrix(a, b, interp)).max()))
    assert worst <= 1e-5, (MODES[interp], worst)
    for a, b in ((5, 3), (3, 5), (7, 2), (9, 9), (10, 5), (5, 10)):  # odd and integer ratios
        np.testing.assert_allclose(FDA.cv2_resize_matrix(a, b, interp), JFDA.cv2_resize_matrix(a, b, interp),
                                   rtol=0, atol=1e-5)


def _faces(n, seed):
    rng = np.random.default_rng(seed)
    return [_rand_face(rng, SIZE) for _ in range(n)]


def test_augment_face_matches_jax_host_path():
    """Byte-exact without a low-res draw; with one, the port resizes with
    cv2's float operators where cv2 resizes uint8 in fixed point. Observed
    worst error over the low-res draws of these 80 seeds, per mode as the
    down / up step (grey levels, mean / p99 / max, the jitter's stretch
    included): NEAREST 0.11 / 1 / 2 down, 0.49 / 1 / 2 up; LINEAR 0.49 / 3
    / 5, 0.32 / 3 / 4; AREA 0.13 / 2 / 3, 0.09 / 1 / 2; CUBIC 0.15 / 2 /
    3, 0.17 / 2 / 5; LANCZOS4 0.18 / 2 / 3, 0.22 / 1 / 3. The bound is the
    one the JAX package holds its own device path to (mean < 3, p99 <= 8)."""
    exact = lowres = 0
    per_mode = {}
    for seed, img in enumerate(_faces(80, 3)):
        kw = dict(crop_prob=0.5, low_res_prob=0.6, photometric_prob=0.5)
        got, score = D.augment_face(img, np.random.default_rng(seed), **kw)
        want, want_score = JD.augment_face(img, np.random.default_rng(seed), **kw)
        assert score == want_score and got.dtype == np.uint8
        draw = D.draw_face_augment_params(np.random.default_rng(seed), SIZE, SIZE, 0.5, 0.6, 0.5)
        if draw.lowres is None:
            np.testing.assert_array_equal(got, want)
            exact += 1
            continue
        lowres += 1
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.mean() < 3.0 and np.quantile(diff, 0.99) <= 8, (draw.lowres, diff.mean())
        key = (MODES[draw.lowres[1]], MODES[draw.lowres[2]])
        per_mode[key] = max(per_mode.get(key, 0), int(diff.max()))
    assert exact >= 20 and lowres >= 30
    assert len({k[0] for k in per_mode}) == 5 and len({k[1] for k in per_mode}) == 5  # every mode ran


def test_low_res_augmentation_matches_jax():
    """The same draws as JAX's `low_res_augmentation` (side ratio and RNG
    state after it equal) and its image within the host low-res bound of
    test_augment_face_matches_jax_host_path (mean < 3, p99 <= 8 grey
    levels; observed at these seeds: mean 0.249, p99 1, max 2)."""
    modes = set()
    for seed, img in enumerate(_faces(30, 9)):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got, ratio = D.low_res_augmentation(img, a)
        want, want_ratio = JD.low_res_augmentation(img, b)
        assert ratio == want_ratio and a.random() == b.random()
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.mean() < 3.0 and np.quantile(diff, 0.99) <= 8, (seed, diff.mean())
        r = np.random.default_rng(seed)
        r.uniform()
        modes.update(int(r.integers(5)) for _ in range(2))
    assert modes == set(range(5))


def _plan_and_host(img, seed, probs, host=D):
    r = np.random.default_rng(seed)
    draw = D.draw_face_augment_params(r, SIZE, SIZE, *probs)
    flip = r.random() < 0.5
    r_host = np.random.default_rng(seed)
    aug, _ = host.augment_face(img, r_host, *probs)
    if r_host.random() < 0.5:
        aug = aug[:, ::-1]
    return draw, flip, D.normalize_face(np.ascontiguousarray(aug))


def _port_device(imgs, draws_flips):
    plan = FDA.stack_face_plans([FDA.plan_face_sample(d, f, SIZE) for d, f in draws_flips])
    return FDA.device_augment_faces(torch.from_numpy(np.stack(imgs)), plan, resample_dtype=torch.float32).numpy()


def _jax_device(imgs, draws_flips):
    plan = JFDA.stack_face_plans([JFDA.plan_face_sample(d, f, SIZE) for d, f in draws_flips])
    return np.asarray(JFDA.device_augment_faces(jnp.asarray(np.stack(imgs)), plan, resample_dtype=jnp.float32))


@pytest.mark.parametrize("lowres", [False, True])
def test_device_augment_matches_jax_and_own_host(lowres):
    probs = (0.5, 0.8 if lowres else 0.0, 0.7)
    imgs = _faces(24, 7)
    parts = [_plan_and_host(img, s, probs) for s, img in enumerate(imgs)]
    draws_flips = [(d, f) for d, f, _ in parts]
    host = np.stack([h for _, _, h in parts])
    got = _port_device(imgs, draws_flips)
    want = _jax_device(imgs, draws_flips)
    assert got.dtype == np.float32 and got.shape == (24, SIZE, SIZE, 3)
    vs_jax = np.abs(got - want)
    vs_host = np.abs(got - host)
    if not lowres:
        # The card's float64 jitter is the host's arithmetic: byte-exact.
        np.testing.assert_array_equal(got, host)
        # Where JAX's float32 blend truncates otherwise, the port is the host.
        assert vs_jax.max() <= LSB * 1.0001 and (vs_jax > 0).mean() < 1e-3
        return
    assert sum(d.lowres is not None for d, _ in draws_flips) >= 12
    # Low-res: both compose the same cv2 operators (within 1e-5 of each
    # other), so the resampled pixels differ by at most 1 grey level; the
    # jitter's factors (<= 1.5, three ops) can stretch that to 4. Observed
    # at these seeds: 1 grey level without a jitter, 3 with one, on 1.1e-4
    # of the values.
    for i, (draw, _) in enumerate(draws_flips):
        bound = 1 if draw.photo is None else 4
        assert vs_jax[i].max() <= bound * LSB * 1.0001, (i, draw)
        if draw.lowres is None:
            np.testing.assert_array_equal(got[i], host[i])
        else:
            assert vs_host[i].mean() < 3.0 * LSB and np.quantile(vs_host[i], 0.99) <= 8 * LSB
    assert (vs_jax > 0).mean() < 1e-3


def test_contrast_anchor_exact():
    """Over a sweep of grey sums the card's anchor equals the host's
    int(mean + 0.5). At 112x112 a float32 mean cannot miss (the sums' spacing
    1/12,544 exceeds float32's rounding near 255); at 512x512 (spacing
    1/262,144) it can: the sum just below a half-way point is found and
    the float32 mean of the JAX device path rounds it up."""
    for side, base in ((SIZE, 0), (SIZE, 127), (SIZE, 254), (512, 200)):
        n = side * side
        sums = [base * n + k for k in range(0, n, max(1, n // 997))] + [base * n + n // 2 + d for d in (-1, 0, 1)]
        gray = np.full((len(sums), side * side), base, np.float64)
        for i, total in enumerate(sums):
            extra = total - base * n
            gray[i, :extra] += 1
        got = FDA.contrast_anchor(torch.from_numpy(gray).view(len(sums), side, side, 1)).numpy()
        host = np.asarray([int(g.mean() + 0.5) for g in gray])
        np.testing.assert_array_equal(got, host)
    # The near-tie: sum = (k - 0.5) * n - 1 at 512x512.
    n = 512 * 512
    total = 200 * n + n // 2 - 1
    g = np.full(n, 200, np.float32)
    g[: n // 2 - 1] += 1
    f32_anchor = int(np.floor(np.float32(g.astype(np.float32).sum(dtype=np.float32) / np.float32(n)) + np.float32(0.5)))
    exact = int(FDA.contrast_anchor(torch.from_numpy(g.astype(np.float64)).view(1, 512, 512, 1))[0])
    assert int(g.mean(dtype=np.float64) + 0.5) == exact == (2 * total + n) // (2 * n) == 200
    assert f32_anchor == 201  # the float32 mean misses it


def _write_tree(root, rng, classes=("a", "b", "c"), per=3, off_size=False):
    for c in classes:
        os.makedirs(os.path.join(root, c))
        for i in range(per):
            img = _rand_face(rng, SIZE)
            if off_size and i == 0:
                img = np.asarray(Image.fromarray(img).resize((96, 130)))
            Image.fromarray(img).save(os.path.join(root, c, f"{i}.png"))


def test_loaders_match_jax_loaders(tmp_path):
    _write_tree(str(tmp_path), np.random.default_rng(2))
    kw = dict(crop_prob=0.5, low_res_prob=0.5, photometric_prob=0.5)
    ds, jds = D.ImageFolderDataset(str(tmp_path), **kw), JD.ImageFolderDataset(str(tmp_path), **kw)
    assert ds.samples == jds.samples and ds.num_classes == 3
    host = list(D.recognition_train_loader(ds, 4, seed=5, num_workers=2))
    jhost = list(JD.recognition_train_loader(jds, 4, seed=5, num_workers=2))
    dev = list(FDA.device_face_train_loader(ds, 4, seed=5, num_workers=2, matrix_dtype=torch.float32))
    jdev = list(JFDA.device_face_train_loader(jds, 4, seed=5, num_workers=2, matrix_dtype=np.float32))
    assert len(host) == len(jhost) == len(dev) == len(jdev) == 2  # 9 samples, drop_last
    counts = [0, 0]  # samples without, with a low-res draw
    for idxs, (img, lab), (jimg, jlab), (u8, plan, dlab), (ju8, jplan, jdlab) in zip(
        D.epoch_order(len(ds), 4, 5), host, jhost, dev, jdev
    ):
        for labels in (jlab, dlab, jdlab):
            np.testing.assert_array_equal(lab, labels)
        assert lab.dtype == np.int32 and img.dtype == np.float32 and u8.dtype == np.uint8
        np.testing.assert_array_equal(u8, ju8)
        for name in ("keep_v", "keep_h", "photo_order"):
            np.testing.assert_array_equal(getattr(plan, name).numpy(), getattr(jplan, name))
        np.testing.assert_allclose(plan.photo.numpy(), jplan.photo, rtol=1e-7)
        np.testing.assert_allclose(plan.mv.numpy(), jplan.mv, rtol=0, atol=1e-5)
        np.testing.assert_allclose(plan.mh.numpy(), jplan.mh, rtol=0, atol=1e-5)
        # Per sample: the host image equals JAX's, and the device image the
        # host's, byte for byte without a low-res draw; with one, both lie
        # within the host low-res bound (mean < 3, p99 <= 8 grey levels).
        got = FDA.device_augment_faces(torch.from_numpy(u8), plan, resample_dtype=torch.float32).numpy()
        for i, idx in enumerate(idxs):
            draw = D.draw_face_augment_params(D.sample_rng(5, idx), SIZE, SIZE, 0.5, 0.5, 0.5)
            counts[draw.lowres is not None] += 1
            if draw.lowres is None:
                np.testing.assert_array_equal(img[i], jimg[i])
                np.testing.assert_array_equal(got[i], img[i])
                continue
            for diff in (np.abs(img[i] - jimg[i]), np.abs(got[i] - img[i])):
                assert diff.mean() < 3 * LSB and np.quantile(diff, 0.99) <= 8 * LSB * 1.0001, (idx, draw)
    assert min(counts) >= 1, counts  # both kinds of sample ran
    bf16 = next(FDA.device_face_train_loader(ds, 4, seed=5, num_workers=1))[1]
    assert bf16.mv.dtype == torch.bfloat16 and bf16.photo.dtype == torch.float64


def test_off_size_source_resized_like_cv2(tmp_path):
    _write_tree(str(tmp_path), np.random.default_rng(4), classes=("x",), per=2, off_size=True)
    ds, jds = D.ImageFolderDataset(str(tmp_path)), JD.ImageFolderDataset(str(tmp_path))
    img, label = ds.load(0)
    assert img.shape == (SIZE, SIZE, 3) and label == 0
    import cv2

    want = cv2.resize(np.asarray(Image.open(jds.samples[0][0]).convert("RGB")), (SIZE, SIZE))
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
    rng = np.random.default_rng(0)
    got, _ = ds.get(1, rng)
    want, _ = jds.get(1, np.random.default_rng(0))
    assert np.abs(got - want).mean() < 3 * LSB
