"""PyTorch port, the rest of inference and WIDER evaluation, against the
JAX package on the trained golden fixture (tests/fixtures/golden_e2e/:
retinaface_mnet025 at 96x96 and three PNGs):

- the golden detections and APs through the port, with the tolerances of
  tests/test_golden_e2e.py;
- `wider_eval` (a copy) on the same predictions and fabricated .mat files;
- `Predictor.detect_images`, `detect_multiscale` and `get_map_txt_rows`;
- `run_wider_val` in its three modes on a small PNG tree (txt dumps), from
  a directory and from the in-memory source;
- the decoder against `cv2.imread`, and chip_smoke.py's PNG reader.
"""

import dataclasses
import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.eval import run_wider as JRW
from jabd_tpu.eval import wider_eval as JW
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu.utils.np_ckpt import load_variables_npz as jax_load_npz
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.eval import run_wider as TRW
from jabd_tpu_torch.eval import wider_eval as TW
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.utils.np_ckpt import load_variables_npz
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_eval import _fake_gt_dir
from tests.test_golden_e2e import FIXTURE_DIR, dump_and_eval

CKPT = os.path.join(FIXTURE_DIR, "ckpt_mnet025_96.npz")
PCFG = dict(confidence=0.5, nms_iou=0.3, input_shape=(96, 96), max_detections=32, pre_nms_topk=64)
STEMS = ("img_0", "img_1", "img_2")


def _image(stem):
    return cv2.imread(os.path.join(FIXTURE_DIR, "images", stem + ".png"))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(FIXTURE_DIR, "golden.npz"), allow_pickle=False))


@pytest.fixture(scope="module")
def predictors():
    """(JAX Predictor, port Predictor) of the trained fixture at float32,
    BatchNorms unfolded, as tests/test_golden_e2e.py builds it."""
    jcfg = dataclasses.replace(JC.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    model = jax_build_model(jcfg, mode="eval")
    template = jax.eval_shape(
        lambda r, x: model.init(r, x, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3))
    )
    jpred = JPredictor(jcfg, jax_load_npz(CKPT, template), JC.PredictConfig(**PCFG), use_pallas=False, fold_bn=False)
    tcfg = dataclasses.replace(TC.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    state = load_variables_npz(CKPT, build_model(tcfg, device="cpu").state_dict())
    tpred = Predictor(tcfg, state, TC.PredictConfig(**PCFG), fold_bn=False, device="cpu")
    return jpred, tpred


def _sorted(d):
    return d[np.argsort(-d[:, 4], kind="stable")]


def test_golden_detections_and_ap_through_the_port(golden, predictors):
    _, tpred = predictors
    fresh = {}
    for stem in STEMS:
        d = tpred.detect_image(_image(stem).astype(np.float32))
        g = golden[f"dets_{stem}"]
        assert len(d) == len(g), (stem, len(d), len(g))
        # observed max error: boxes 1.5e-5 px, scores 6e-8
        np.testing.assert_allclose(_sorted(d)[:, :4], _sorted(g)[:, :4], atol=2e-2, rtol=0)
        np.testing.assert_allclose(_sorted(d)[:, 4], _sorted(g)[:, 4], atol=1e-3, rtol=0)
        fresh[f"dets_{stem}"] = d
        fresh[f"gt_{stem}"] = golden[f"gt_{stem}"]
    aps = dump_and_eval(fresh, TW.evaluate_wider)
    np.testing.assert_allclose([aps["easy"], aps["medium"], aps["hard"]], golden["aps"], atol=5e-3, rtol=0)
    assert all(0.0 < v <= 1.0 for v in aps.values())


def _fake_preds(rng, events):
    out = {}
    for ev, imgs in events.items():
        out[ev] = {}
        for img, gts in imgs.items():
            g = np.asarray(gts, float).reshape(-1, 4)
            hits = g + rng.normal(0, 2, g.shape)
            misses = rng.uniform(0, 300, (4, 4))
            boxes = np.concatenate([hits, misses])
            scores = rng.uniform(0.05, 0.99, len(boxes))
            rows = np.concatenate([boxes, scores[:, None]], 1)
            out[ev][img] = rows[np.argsort(-scores, kind="stable")]
    return out


def test_wider_eval_copy_gives_jax_aps(rng, tmp_path):
    events = {
        "0--Parade": {"a": [[10, 10, 30, 40], [100, 80, 25, 25], [50, 5, 8, 9]], "b": [[5, 5, 50, 50]], "c": []},
        "1--Handshaking": {"d": [[20, 20, 40, 30], [60, 60, 12, 14]]},
    }
    gt_dir = _fake_gt_dir(tmp_path, events)
    pred = _fake_preds(rng, events)
    twin = {ev: {k: v.copy() for k, v in imgs.items()} for ev, imgs in pred.items()}
    want = JW.evaluate_wider(pred, gt_dir, iou_thresh=0.4)
    got = TW.evaluate_wider(twin, gt_dir, iou_thresh=0.4)
    assert got == want and 0 < got["hard"] < 1, (got, want)
    for ev in pred:
        for k in pred[ev]:
            np.testing.assert_array_equal(twin[ev][k], pred[ev][k])  # both normalized the same


def test_detect_images_matches_jax_and_detect_image(predictors):
    """Mixed sizes in one batch (bucket 128 x 2048, one source over the
    cap): rows exact in count; the identity-size image (96x96) equals
    detect_image."""
    jpred, tpred = predictors
    rng = np.random.default_rng(4)
    ident = cv2.resize(_image("img_0"), (96, 96), interpolation=cv2.INTER_AREA)
    big = cv2.resize(_image("img_1"), (150, 230))
    strip = np.tile(_image("img_2"), (1, 33, 1))[:, :2100]  # over the 2048 cap: shrunk first
    images = [ident, _image("img_1"), _image("img_2"), big, rng.integers(0, 256, (70, 90, 3), dtype=np.uint8), strip]
    got = tpred.detect_images(images)
    want = jpred.detect_images(images)
    assert [len(g) for g in got] == [len(w) for w in want] and sum(map(len, got)) > 0
    for g, w in zip(got[:-1], want[:-1]):
        # observed max error 3.1e-5 px (bfloat16 resample, whole grey levels)
        np.testing.assert_allclose(_sorted(g), _sorted(np.asarray(w)), atol=0.05, rtol=1e-4)
    # The strip's pre-shrink is torch bilinear here, cv2's fixed point there
    # (1 grey level), and a pixel of the frame is 22 of the source: observed
    # max error 0.093 px on boxes up to 2,190 px, 0.22 px on landmarks,
    # scores 3.1e-4.
    g, w = _sorted(got[-1]), _sorted(np.asarray(want[-1]))
    np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.25, rtol=0)
    np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(g, w, atol=0.5, rtol=0)
    single = tpred.detect_image(ident)
    assert got[0].shape == single.shape and len(single)
    # observed max error 1.1e-5
    np.testing.assert_allclose(got[0], single, atol=2e-3, rtol=0)
    assert tpred.detect_images([]) == []


@pytest.mark.parametrize("scales", [(0.5, 1.0, 1.5), (0.75, 1.25)])
def test_detect_multiscale_and_map_txt_rows_match_jax(predictors, scales):
    jpred, tpred = predictors
    for stem in STEMS:
        img = _image(stem)
        got = tpred.detect_multiscale(img, scales=scales)
        want = np.asarray(jpred.detect_multiscale(img, scales=scales))
        assert got.shape == want.shape, stem
        # observed max error 3.7e-5 px (float frames on both sides)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=stem)
        # A uint8 image's host letterbox rounds to whole grey levels, the
        # port's and cv2's differently (1 level at most): observed max
        # error 9.8e-3 px, scores 1.3e-3.
        rows = tpred.get_map_txt_rows(img)
        want = jpred.get_map_txt_rows(img)
        np.testing.assert_allclose(rows[:, :4], want[:, :4], atol=0.05, rtol=0)
        np.testing.assert_allclose(rows[:, 4], want[:, 4], atol=5e-3, rtol=0)
        assert rows.shape[1] == 5 and np.all(np.diff(rows[:, 4]) <= 0)


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    """Two events of PNGs at 64-128 px: the golden images, a crop and a
    flip of each, written with cv2."""
    root = tmp_path_factory.mktemp("val")
    for e, event in enumerate(("0--Parade", "1--Handshaking")):
        os.makedirs(root / event)
        for stem in STEMS:
            img = _image(stem)
            if e:
                img = np.ascontiguousarray(img[:, ::-1])
            cv2.imwrite(str(root / event / f"{stem}.png"), img)
        cv2.imwrite(str(root / event / "crop.png"), _image(STEMS[e])[4:-4, 8:])
    return str(root)


def _read_dump(root):
    out = {}
    for event in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, event))):
            with open(os.path.join(root, event, name)) as f:
                lines = f.read().splitlines()
            rows = np.asarray([[float(v) for v in line.split()] for line in lines[2:]]).reshape(-1, 5)
            out[(event, name)] = (lines[0], int(lines[1]), rows)
    return out


MODES = {"single": {}, "host": {"multiscale": True}, "device": {"multiscale": True, "pyramid": "device"}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_wider_val_matches_jax(predictors, val_tree, tmp_path, mode):
    jpred, tpred = predictors
    kw = MODES[mode]
    want = JRW.run_wider_val(jpred, val_tree, batch_size=3, out_dir=str(tmp_path / "jax"), num_workers=2, **kw)
    got = TRW.run_wider_val(tpred, val_tree, batch_size=3, out_dir=str(tmp_path / "port"), num_workers=2, **kw)
    assert got.keys() == want.keys()
    for event in want:
        assert got[event].keys() == want[event].keys()
        for stem, w in want[event].items():
            assert got[event][stem].shape == w.shape, (mode, event, stem)
            # Single scale rounds the uint8 host letterbox (torch bilinear
            # vs cv2's fixed point, 1 grey level at most): observed max
            # error 0.014 px, scores 1.3e-3; with the pyramids (float
            # frames) 2.3e-5 px, scores 3.6e-7.
            np.testing.assert_allclose(got[event][stem][:, :4], w[:, :4], atol=0.05, rtol=0)
            np.testing.assert_allclose(got[event][stem][:, 4], w[:, 4], atol=5e-3, rtol=0)
    jd, td = _read_dump(str(tmp_path / "jax")), _read_dump(str(tmp_path / "port"))
    assert jd.keys() == td.keys() and len(td) == 8
    for key, (header, n, rows) in jd.items():
        assert td[key][:2] == (header, n), key
        np.testing.assert_allclose(td[key][2], rows, atol=0.05, rtol=0)
    assert sum(n for _, n, _ in td.values()) > 0
    # The port's own dump renders what it returned, byte for byte.
    for (event, name), (header, n, _) in td.items():
        rows = got[event][os.path.splitext(name)[0]]
        text = "".join(f"{r[0]:.3f} {r[1]:.3f} {r[2]:.3f} {r[3]:.3f} {r[4]:.5f}\n" for r in rows)
        with open(tmp_path / "port" / event / name) as f:
            assert f.read() == f"{header}\n{n}\n{text}"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_wider_val_in_memory_source_equals_directory(predictors, val_tree, mode):
    """The in-memory mapping {(event, name): BGR array} gives what the
    directory gives, at another batch size (a partial last batch)."""
    _, tpred = predictors
    images = {item: TRW.decode_bgr(os.path.join(val_tree, *item)) for item in TRW._list_val_images(val_tree)}
    from_dir = TRW.run_wider_val(tpred, val_tree, batch_size=8, num_workers=2, **MODES[mode])
    from_mem = TRW.run_wider_val(tpred, images, batch_size=3, num_workers=1, **MODES[mode])
    assert from_mem.keys() == from_dir.keys()
    for event in from_dir:
        for stem, rows in from_dir[event].items():
            # observed max error 0.0 (batch size does not change a row)
            np.testing.assert_allclose(from_mem[event][stem], rows, atol=1e-4, rtol=0)


def test_decoder_gives_what_cv2_imread_gives(val_tree, tmp_path):
    for event, name in TRW._list_val_images(val_tree):
        path = os.path.join(val_tree, event, name)
        np.testing.assert_array_equal(TRW.decode_bgr(path), cv2.imread(path))
    from PIL import Image

    # An EXIF-rotated JPEG (orientation 6): cv2.imread transposes it; so
    # must the decoder and the bucket scan (tests/test_e2e_wider.py).
    os.makedirs(tmp_path / "0--Parade")
    im = Image.new("RGB", (300, 100), (200, 30, 90))
    exif = im.getexif()
    exif[274] = 6
    path = str(tmp_path / "0--Parade" / "rot.jpg")
    im.save(path, exif=exif)
    want = cv2.imread(path)
    got = TRW.decode_bgr(path)
    assert got.shape == want.shape == (300, 100, 3)
    assert np.abs(got.astype(int) - want).max() <= 2  # two JPEG decoders
    assert np.abs(got[150, 50].astype(int) - (90, 30, 200)).max() <= 3  # BGR
    bh, bw = TRW._scan_bucket(str(tmp_path), [("0--Parade", "rot.jpg")])
    assert (bh, bw) == JRW._scan_bucket(str(tmp_path), [("0--Parade", "rot.jpg")]) == (384, 128)
    assert TRW._scan_bucket({("e", "x"): got}, [("e", "x")]) == (384, 128)


@pytest.mark.parametrize(
    "name,kw",
    [("q95_444", dict(quality=95, subsampling=0)),
     ("q75_420", dict(quality=75, subsampling=2)),
     ("q85_420_progressive", dict(quality=85, subsampling=2, progressive=True))],
)
def test_decoder_gives_what_cv2_imread_gives_on_textured_jpegs(tmp_path, name, kw):
    """WIDER is all JPEG: seeded noise over colour gradients, 1024x768, at
    q 95 with 4:4:4 chroma, q 75 with 4:2:0, and a progressive file; the
    port's decoder (PIL) against cv2.imread (libjpeg), byte for byte
    (observed: identical with PIL 12.1.0 and cv2 5.0.0)."""
    from PIL import Image

    rng = np.random.default_rng(17)
    h, w = 768, 1024
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w * 255, yy / h * 255, (xx + yy) / (w + h) * 255], -1)
    rgb = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / f"{name}.jpg")
    Image.fromarray(rgb).save(path, **kw)
    want = cv2.imread(path)
    got = TRW.decode_bgr(path)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def _write_png(path, rgb, filters):
    """A PNG whose row y uses scanline filter filters[y % len]."""
    h, w, _ = rgb.shape
    bpp, stride = 3, 3 * w
    rows = rgb.reshape(h, stride).astype(np.int32)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur, prev = rows[y], rows[y - 1] if y else np.zeros(stride, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) // 2, paeth][f]
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_chip_smoke_png_reader_gives_what_cv2_imread_gives(rng, tmp_path):
    import chip_smoke

    for stem in STEMS:
        path = os.path.join(FIXTURE_DIR, "images", stem + ".png")
        np.testing.assert_array_equal(chip_smoke.read_png(path), cv2.imread(path))
    rgb = rng.integers(0, 256, (23, 17, 3), dtype=np.uint8)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = str(tmp_path / "f.png")
        _write_png(path, rgb, filters)
        np.testing.assert_array_equal(cv2.imread(path), rgb[:, :, ::-1])
        np.testing.assert_array_equal(chip_smoke.read_png(path), rgb[:, :, ::-1])
