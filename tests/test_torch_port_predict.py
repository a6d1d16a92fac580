"""PyTorch port, the serving slice: postprocess on the same head outputs,
the Predictor entry points against the JAX Predictor (XLA NMS) end to
end, the batching server, and the device policy of the entry points.
"""

import dataclasses
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import predict as JP
from jabd_tpu.ops import anchors as JA
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import predict as TP
from jabd_tpu_torch.ops import nms as TN
from jabd_tpu_torch.serve import BatchingDetector
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_model import flagship_variables

HW = (64, 64)


def _pcfgs(**kw):
    kw = {"confidence": 0.02, "input_shape": HW, **kw}
    return JC.PredictConfig(**kw), TC.PredictConfig(**kw)


@pytest.fixture(scope="module")
def predictors():
    cfg = dataclasses.replace(JC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model, variables = flagship_variables(cfg, HW, seed=1)
    jp_cfg, tp_cfg = _pcfgs()
    jpred = JP.Predictor(cfg, variables, jp_cfg, use_pallas=False)
    tcfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    state = state_dict_from_flax(variables)
    tpred = TP.Predictor(tcfg, state, tp_cfg, device="cpu")
    return model, variables, jpred, tpred, state, tcfg


def _heads(rng, bsz, p, ties):
    loc = rng.normal(0, 1, (bsz, p, 4)).astype(np.float32)
    landm = rng.normal(0, 1, (bsz, p, 10)).astype(np.float32)
    s = rng.uniform(0, 1, (bsz, p)).astype(np.float32)
    if ties:  # letterbox fill: long runs of exactly equal scores
        s[:, ::3] = 0.5
        s[:, 1::7] = 0.25
    cls = np.stack([1 - s, s], -1)
    return loc, cls, landm


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("topk,max_det", [(5000, 750), (100, 40)])
def test_postprocess_same_heads_same_dets(rng, ties, topk, max_det):
    anchors = JA.generate_anchors(JC.CFG_MNET, (96, 64))
    loc, cls, landm = _heads(rng, 3, len(anchors), ties)
    jcfg, tcfg = _pcfgs(confidence=0.3, pre_nms_topk=topk, max_detections=max_det)
    jd, jv = JP.postprocess_outputs(
        jnp.asarray(loc), jnp.asarray(cls), jnp.asarray(landm), jnp.asarray(anchors), jcfg
    )
    td, tv = TP.postprocess_outputs(
        torch.from_numpy(loc), torch.from_numpy(cls), torch.from_numpy(landm),
        torch.from_numpy(anchors.copy()), tcfg,
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any(axis=1).all()
    # observed max error 2.4e-7; stated tolerance 1e-6
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def test_postprocess_same_jax_head_outputs(predictors, rng):
    """The JAX flagship's own head outputs through both postprocesses."""
    model, variables, _, _, _, _ = predictors
    x = rng.normal(0, 50, (2, *HW, 3)).astype(np.float32)
    apply = jax.jit(functools.partial(model.apply, train=False))
    loc, cls, landm = (np.array(a) for a in apply(variables, jnp.asarray(x)))
    anchors = JA.generate_anchors(JC.CFG_MNET, HW)
    jcfg, tcfg = _pcfgs()
    jd, jv = JP.postprocess_outputs(
        jnp.asarray(loc), jnp.asarray(cls), jnp.asarray(landm), jnp.asarray(anchors), jcfg
    )
    td, tv = TP.postprocess_outputs(
        *(torch.from_numpy(a) for a in (loc, cls, landm)),
        torch.from_numpy(anchors.copy()), tcfg, keep_fn=TN.nms_keep_sorted,
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # observed max error 6.0e-8; stated tolerance 1e-6
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def _assert_dets_close(got, want, atol):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_detect_preprocessed_matches_jax(predictors, rng):
    _, _, jpred, tpred, _, _ = predictors
    x = rng.normal(0, 50, (2, *HW, 3)).astype(np.float32)
    jd, jv = jpred.detect_preprocessed(x)
    td, tv = tpred.detect_preprocessed(x)
    assert tuple(td.shape) == (2, 750, 15) and tv.device.type == "cpu"
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # observed max error 4.8e-7 in normalized coords; stated tolerance 1e-5
    _assert_dets_close(td.numpy(), np.asarray(jd), 1e-5)


@pytest.mark.parametrize("hw", [(64, 64), (128, 96), (96, 128)])
def test_detect_image_matches_jax(predictors, rng, hw):
    """Unscaled and exact-2x images letterbox byte-exactly in both
    front ends, so the detections agree to float32 rounding."""
    _, _, jpred, tpred, _, _ = predictors
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = jpred.detect_image(img)
    got = tpred.detect_image(img)
    assert len(want) > 0
    # observed max error 6.1e-5 px; stated tolerance 1e-3 px
    _assert_dets_close(got, want, 1e-3)


def test_unfolded_predictor_matches_folded(predictors, rng):
    _, _, _, tpred, state, tcfg = predictors
    unfolded = TP.Predictor(tcfg, state, tpred.pcfg, fold_bn=False, device="cpu")
    x = rng.normal(0, 50, (1, *HW, 3)).astype(np.float32)
    d0, v0 = tpred.detect_preprocessed(x)
    d1, v1 = unfolded.detect_preprocessed(x)
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    # observed max error 3.6e-7; stated tolerance 3e-5
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), atol=3e-5, rtol=0)


def test_batching_detector_answers_every_request(predictors, rng):
    _, _, _, tpred, _, _ = predictors
    images = [rng.integers(0, 256, (40 + 8 * i, 80 - 4 * i, 3), dtype=np.uint8) for i in range(6)]
    server = BatchingDetector(tpred, batch_size=4, max_wait_ms=50.0)
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            results = list(pool.map(server.detect, images))
    finally:
        server.close()
    assert not server._worker.is_alive()
    assert server.stats()["requests"] == 6
    for img, got in zip(images, results):
        want = tpred.detect_image(img)
        assert got.shape == want.shape
        # batch-mates change nothing but float32 rounding; observed 3.1e-5 px
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_undo_letterbox_pixels_matches_jax(rng):
    dets = rng.uniform(0, 1, (9, 15)).astype(np.float32)
    for hw in ((48, 96), (100, 37)):
        want = JP.undo_letterbox_pixels(dets.copy(), HW, hw)
        got = TP.undo_letterbox_pixels(dets.copy(), HW, hw)
        np.testing.assert_array_equal(got, want)
    assert TP.undo_letterbox_pixels(np.zeros((0, 15), np.float32), HW, (5, 5)).shape == (0, 15)


def test_predictor_without_device_and_card_raises(predictors, monkeypatch):
    _, _, _, tpred, state, tcfg = predictors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.Predictor(tcfg, state, tpred.pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingDetector(TP.Predictor(tcfg, state, tpred.pcfg))


def test_get_fps_needs_the_card(predictors, rng):
    _, _, _, tpred, _, _ = predictors
    with pytest.raises(RuntimeError, match="CUDA events"):
        tpred.get_fps(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), test_interval=1)


def test_concurrent_predictor_calls_agree(predictors, rng):
    """detect_image from several threads at once gives what one thread gets."""
    _, _, _, tpred, _, _ = predictors
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    want = tpred.detect_image(img)
    out = []
    lock = threading.Lock()

    def worker():
        got = tpred.detect_image(img)
        with lock:
            out.append(got)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(out) == 4
    for got in out:
        np.testing.assert_array_equal(got, want)
