"""PyTorch port, the detect -> align -> embed -> identify pipeline
(pipeline.py, serve.IdentityService, `cli identify`, `cli serve --arch`)
against `jabd_tpu/pipeline.py` and `jabd_tpu/serve.py`, on the CPU in
float32: retinaface_mnet025 at 64x64 with seeded weights, ir_18 with the
golden fixture's path-keyed weights (chip_smoke.golden_ir_state_dict):

- `embed_crops` with N = 0, N < embed_batch and N not a multiple of it
  (within 1e-5 of JAX's);
- `analyze`: detections within 2e-3 px of JAX's, embeddings within 1e-3
  (a crop pixel can round to the neighbouring grey level when a landmark
  moves by 1e-3 px);
- `Gallery` npz files written by each package and read by the other;
  `enroll_directory` over a PNG tree against JAX's (an undecodable file
  skipped by both);
- `IdentityService.analyze` JSON against JAX's on the same detections;
- the `cli identify` journey (enrol, save the npz, identify, draw; then
  again from the npz) against `jabd_tpu.cli identify` on the same .pth
  files (rows equal within a print step; observed equal), and `cli serve
  --arch` answering POST /identify as the JAX package's `serve --arch`
  service does (embeddings within 1e-5; observed 1e-6, the 6-place
  rounding).
"""

import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from jabd_tpu import cli as JCLI
from jabd_tpu import configs as JC
from jabd_tpu import pipeline as JP
from jabd_tpu import serve as JS
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu.recognition import net as JN
from jabd_tpu_torch import cli
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import pipeline as TP
from jabd_tpu_torch import serve as S
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.recognition import build_model
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax
from jabd_tpu_torch.utils.torch_convert import export_state_dict_auto, save_pth
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables
from tests.test_torch_port_recognition_eval import reference_pth  # noqa: F401
from tests.test_torch_port_serve import _Server

DET = "retinaface_mnet025"
SIZE = 64
PCFG = dict(confidence=0.02, input_shape=(SIZE, SIZE), max_detections=12, pre_nms_topk=128)
BATCH = 4


def _scene(seed, h=96, w=128):
    return chip_smoke.smooth_image(np.random.default_rng(seed), h, w)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JC.get_model_config(DET), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config(DET), compute_dtype="float32")
    jdet = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(functools.partial(jdet.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    dvars = seeded_variables(shapes, seed=11)
    jpred = JPredictor(jcfg, dvars, JC.PredictConfig(**PCFG), use_pallas=False)
    tpred = Predictor(tcfg, state_dict_from_flax(dvars), TC.PredictConfig(**PCFG), device="cpu")
    state = chip_smoke.golden_ir_state_dict("ir_18")
    emb = build_model("ir_18", device="cpu")
    emb.load_state_dict(state)
    jpipe = JP.FacePipeline(jpred, JN.build_model("ir_18"), flax_from_state_dict(state), embed_batch=BATCH)
    tpipe = TP.FacePipeline(tpred, emb, embed_batch=BATCH, device="cpu")
    return dict(jpipe=jpipe, tpipe=tpipe, dvars=dvars)


@pytest.mark.parametrize("n", [0, 3, 6])
def test_embed_crops(setup, n, rng):
    crops = rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8)
    got = setup["tpipe"].embed_crops(crops)
    assert got.shape == (n, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, setup["jpipe"].embed_crops(crops), rtol=0, atol=1e-5)


def test_analyze_matches_jax(setup):
    total = 0
    for seed in (1, 2):
        img = _scene(seed)
        dets, embs = setup["tpipe"].analyze(img)
        jdets, jembs = setup["jpipe"].analyze(img)
        assert dets.shape == jdets.shape and embs.shape == (len(dets), 512)
        np.testing.assert_allclose(dets, jdets, rtol=0, atol=2e-3)
        np.testing.assert_allclose(embs, jembs, rtol=0, atol=1e-3)
        total += len(dets)
    assert total > 0


def test_gallery_npz_both_directions(tmp_path, rng):
    embs = rng.normal(0, 1, (3, 2, 16)).astype(np.float32)
    for save_cls, load_cls in ((TP.Gallery, JP.Gallery), (JP.Gallery, TP.Gallery)):
        g = save_cls()
        for name, e in zip(("ann", "bob", "cy"), embs):
            g.enroll(name, e)
        path = str(tmp_path / f"{save_cls.__module__}.npz")
        g.save(path)
        back = load_cls.load(path)
        assert back.names == ["ann", "bob", "cy"]
        np.testing.assert_array_equal(back.matrix, g.matrix)
        q = rng.normal(0, 1, (4, 16)).astype(np.float32)
        assert back.match(q, threshold=0.1) == g.match(q, threshold=0.1)
    assert TP.Gallery().match(np.ones((1, 4), np.float32)) == [(None, -1.0)]


def _png(path, bgr):
    Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(path)


@pytest.fixture(scope="module")
def gallery_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("gallery")
    for name, seeds in (("ann", (3, 4)), ("bob", (5,))):
        os.makedirs(root / name)
        for s in seeds:
            _png(root / name / f"{s}.png", _scene(s))
    (root / "bob" / "broken.jpg").write_bytes(b"not an image")
    (root / "notes.txt").write_text("not a person")
    return root


def test_enroll_directory_matches_jax(setup, gallery_tree):
    got = TP.enroll_directory(setup["tpipe"], str(gallery_tree))
    want = JP.enroll_directory(setup["jpipe"], str(gallery_tree))
    assert got.names == want.names == ["ann", "bob"]
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=0, atol=1e-3)


def test_identity_service_json_matches_jax(setup, gallery_tree):
    gallery = TP.enroll_directory(setup["tpipe"], str(gallery_tree))
    img = _scene(3)
    dets = setup["tpipe"].predictor.detect_image(img)
    got = S.IdentityService(setup["tpipe"], gallery, threshold=0.5).analyze(img, dets)
    want = JS.IdentityService(setup["jpipe"], gallery, threshold=0.5).analyze(img, dets)
    assert len(got) == len(want) == len(dets) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"box", "score", "landmarks", "name", "cosine", "embedding"}
        assert g["box"] == w["box"] and g["score"] == w["score"] and g["landmarks"] == w["landmarks"]
        assert g["name"] == w["name"] and abs(g["cosine"] - w["cosine"]) <= 2e-4
        np.testing.assert_allclose(g["embedding"], w["embedding"], rtol=0, atol=1e-5)
    json.dumps(got)
    assert S.IdentityService(setup["tpipe"]).analyze(img, dets[:0]) == []


@pytest.fixture()
def weights(setup, reference_pth, tmp_path, monkeypatch):
    """Both packages' CLIs at float32, reading one detector .pth (the
    seeded mnet025 under the reference's names) and one IR-18 .pth."""
    for mod in (JC, TC):
        get = mod.get_model_config
        monkeypatch.setattr(mod, "get_model_config",
                            lambda name, get=get: dataclasses.replace(get(name), compute_dtype="float32"))
    det = str(tmp_path / "det.pth")
    save_pth(export_state_dict_auto(state_dict_from_flax(setup["dvars"]), TC.get_model_config(DET)), det)
    return ["--weights", det, "--ckpt", reference_pth[1]]


ID_ARGS = ["--model", DET, "--input-size", "32", "--confidence", "0.5", "--arch", "ir_18"]


def _rows(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _assert_rows_close(got, want):
    """Rows printed by the two CLIs: boxes are printed to 0.1 px and the
    detections agree within 2e-3 px, so a box may sit one print step
    apart; scores within 1e-4 plus a print step, cosines within 2e-3
    (embeddings within 1e-3, see test_analyze_matches_jax)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"box", "score", "name", "cosine"} and g["name"] == w["name"]
        np.testing.assert_allclose(g["box"], w["box"], rtol=0, atol=0.1 + 1e-6)
        assert abs(g["score"] - w["score"]) <= 2e-4 and abs(g["cosine"] - w["cosine"]) <= 2e-3


def test_cli_identify_journey(weights, gallery_tree, tmp_path, capsys):
    probe = tmp_path / "probe.png"
    _png(probe, _scene(3))
    rows = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", JCLI.main, [])):
        out, npz = tmp_path / f"{name}.png", tmp_path / f"{name}.npz"
        base = ["identify", *ID_ARGS, *weights, *extra, "--image", str(probe), "--gallery", str(npz),
                "--out", str(out)]
        main(base + ["--gallery-dir", str(gallery_tree)])
        first = capsys.readouterr()
        assert out.exists() and npz.exists() and "enrolled 2 identities" in first.err
        rows[name] = _rows(first.out)
        main(base)  # again, from the saved npz
        second = capsys.readouterr()
        assert "loaded 2 identities" in second.err and _rows(second.out) == rows[name]
    _assert_rows_close(rows["port"], rows["jax"])
    got, want = TP.Gallery.load(str(tmp_path / "port.npz")), JP.Gallery.load(str(tmp_path / "jax.npz"))
    assert got.names == want.names == ["ann", "bob"]
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=0, atol=1e-3)
    port_id = ["identify", *ID_ARGS, "--device", "cpu", "--image", str(probe)]
    with pytest.raises(SystemExit, match="need --gallery-dir"):
        cli.main(port_id)
    with pytest.raises(SystemExit, match="not wired for `identify`"):
        cli.main(port_id + ["--quantize", "int8"])


def test_cli_serve_arch_answers_identify(weights, gallery_tree, tmp_path, monkeypatch):
    """The port's daemon from `cli serve --arch` answers POST /identify as
    the JAX package's `cli serve --arch` service does on the same .pth
    files, gallery and detections: names equal, embeddings within 1e-5."""
    npz = tmp_path / "g.npz"
    started = {}
    monkeypatch.setattr(S, "serve", lambda det, host, port, identity: started.update(det=det, identity=identity))
    monkeypatch.setattr(JS, "serve", lambda det, host, port, identity: started.update(jdet=det, jid=identity))
    cli.main(["identify", *ID_ARGS, *weights, "--device", "cpu", "--image", str(gallery_tree / "ann" / "3.png"),
              "--gallery", str(npz), "--gallery-dir", str(gallery_tree)])
    cli.main(["serve", *ID_ARGS, *weights, "--device", "cpu", "--gallery", str(npz), "--batch-size", "2"])
    JCLI.main(["serve", *ID_ARGS, *weights, "--gallery", str(npz), "--batch-size", "2"])
    started["jdet"].close()
    identity = started["identity"]
    assert identity.gallery.names == started["jid"].gallery.names == ["ann", "bob"]
    img = _scene(3)
    buf = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(buf, format="PNG")
    with _Server(functools.partial(S.make_server, identity=identity), started["det"]) as srv:
        code, body = srv.call("/identify", buf.getvalue())
        det_code, det_body = srv.call("/detect", buf.getvalue())
    assert code == 200 and det_code == 200 and body["count"] == det_body["count"] > 0
    dets = started["det"].backend.detect_image(img)
    want = started["jid"].analyze(img, dets)
    assert [f["box"] for f in body["faces"]] == [f["box"] for f in want]
    assert [f["name"] for f in body["faces"]] == [f["name"] for f in want]
    np.testing.assert_allclose([f["embedding"] for f in body["faces"]], [f["embedding"] for f in want], atol=1e-5)
