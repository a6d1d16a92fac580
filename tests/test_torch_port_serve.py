"""PyTorch port, the HTTP daemon (serve.py: `make_server` over a
`BatchingDetector`), on the CPU at 64x64 in float32:

- concurrent POST /detect answers equal `detect_image` on the decoded
  frame, and the JAX package's daemon over the same variables;
- /healthz counts, 404s, the 503 on /identify without an embedder, 400 on
  an undecodable body;
- an artifact backend: its batch size is enforced, its shape is used;
- `decode_bgr` of bytes equals its path form and `cv2.imdecode`.
"""

import dataclasses
import functools
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from jabd_tpu import configs as JC
from jabd_tpu import serve as JS
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu_torch import aot
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import serve as S
from jabd_tpu_torch.eval.run_wider import decode_bgr
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables

SIZE = 64
PCFG = dict(confidence=0.3, input_shape=(SIZE, SIZE), max_detections=64, pre_nms_topk=256)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JC.get_model_config("jabd_flagship"), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))
    )
    variables = seeded_variables(shapes, seed=8)
    pred = Predictor(tcfg, state_dict_from_flax(variables), TC.PredictConfig(**PCFG), device="cpu")
    return dict(jcfg=jcfg, variables=variables, pred=pred)


def _png(bgr):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(buf, format="PNG")
    return buf.getvalue()


class _Server:
    """make_server on a free port in a thread; closed on exit."""

    def __init__(self, make, detector):
        self.detector = detector
        self.srv = make(detector, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.detector.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def call(self, path, body=None):
        req = urllib.request.Request(self.url + path, data=body, method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def test_concurrent_answers_equal_detect_image(setup, rng):
    frames = [rng.integers(0, 256, (40 + 9 * i, 90 - 5 * i, 3), dtype=np.uint8) for i in range(8)]
    bodies = [_png(f) for f in frames]
    with _Server(S.make_server, S.BatchingDetector(setup["pred"], batch_size=4, max_wait_ms=200.0)) as srv:
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda b: srv.call("/detect", b), bodies))
        code, stats = srv.call("/healthz")
    assert code == 200 and stats["requests"] == 8 and 2 <= stats["batches"] <= 8
    for (code, ans), frame in zip(answers, frames):
        want = setup["pred"].detect_image(frame)
        got = np.asarray(ans["faces"], np.float64).reshape(-1, 15)
        assert code == 200 and ans["count"] == len(want) == len(got)
        # JSON rounds to 1e-3 (half a step is 5e-4); batch 4 against batch
        # 1 reorders float32 sums. Observed max abs diff 5.3e-4 px.
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert sum(a["count"] for _, a in answers) > 0


def test_answers_match_the_jax_daemon(setup, rng):
    """The same PNG bodies to both packages' daemons. Frames at the input
    size, so neither letterbox resamples (the port resizes without cv2);
    float32 on both sides, observed max abs diff 1e-3 (one JSON rounding
    step) over the faces."""
    frames = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(4)]
    bodies = [_png(f) for f in frames]
    jpred = JPredictor(setup["jcfg"], setup["variables"], JC.PredictConfig(**PCFG), use_pallas=False)
    answers = {}
    for name, make, det in (
        ("port", S.make_server, S.BatchingDetector(setup["pred"], batch_size=2)),
        ("jax", JS.make_server, JS.BatchingDetector(jpred, batch_size=2)),
    ):
        with _Server(make, det) as srv:
            answers[name] = [srv.call("/detect", b)[1] for b in bodies]
    for got, want in zip(answers["port"], answers["jax"]):
        assert got["count"] == want["count"]
        np.testing.assert_allclose(np.asarray(got["faces"]), np.asarray(want["faces"]), rtol=0, atol=2e-3)
    assert sum(a["count"] for a in answers["port"]) > 0


def test_http_errors(setup):
    with _Server(S.make_server, S.BatchingDetector(setup["pred"], batch_size=2)) as srv:
        assert srv.call("/nope")[0] == 404
        assert srv.call("/nope", b"x")[0] == 404
        code, body = srv.call("/identify", _png(np.zeros((8, 8, 3), np.uint8)))
        assert code == 503 and "no embedder" in body["error"]
        code, body = srv.call("/detect", b"not an image")
        assert code == 400 and body == {"error": "undecodable image"}
        assert srv.call("/healthz")[1]["requests"] == 0


def test_artifact_backend(setup, rng, tmp_path):
    aot.export_detector(setup["pred"], str(tmp_path), batch_size=2)
    art = aot.load_exported(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="--batch-size 2"):
        S.BatchingDetector(art, batch_size=3)
    det = S.BatchingDetector(art, batch_size=2)
    assert det.input_shape == (SIZE, SIZE) and det.letterbox is True
    frame = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    with _Server(S.make_server, det) as srv:
        code, ans = srv.call("/detect", _png(frame))
    want = art.detect_image(frame)
    assert code == 200 and ans["count"] == len(want)
    np.testing.assert_allclose(np.asarray(ans["faces"]).reshape(-1, 15), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_decode_bgr_bytes(rng, tmp_path, fmt):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / f"a{fmt}")
    cv2.imwrite(path, img)
    raw = open(path, "rb").read()
    got = decode_bgr(raw)
    np.testing.assert_array_equal(got, decode_bgr(path))
    np.testing.assert_array_equal(got, cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR))
