"""PyTorch port, data-mode serving over a local mesh on the CPU: a mesh of
two CPU entries (`make_mesh(["cpu", "cpu"])`, a replica each) against the
JAX package's Predictor on a 2-device CPU mesh (tests/conftest.py gives
JAX 8 virtual devices; its data mode runs the detect graph under
shard_map), on the trained golden fixture of tests/test_torch_port_eval.py
(retinaface_mnet025 at 96x96, float32, BatchNorms unfolded):

- `detect_preprocessed` and `detect_images` (mixed sizes), against JAX's
  mesh Predictor and the port's single-replica one; each replica's frames
  against the dense letterbox recipe, bit for bit;
- an indivisible batch raises; a mesh of one is the plain path;
- the WIDER sweep over the mesh against JAX's sweep dumps;
- an artifact served over the mesh (`load_exported(mesh=)`);
- `BatchingDetector`'s divisibility check;
- `cli serve / dir-predict / map-txt --data-parallel --device cpu,cpu`
  against `jabd_tpu.cli ... --data-parallel`, `--spatial` beside them
  (tests/test_torch_port_spatial.py holds it to one device) and the
  flags' exits.
"""

import dataclasses
import os
import threading

import cv2
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jabd_tpu import cli as JCLI
from jabd_tpu import configs as JC
from jabd_tpu.eval import run_wider as JRW
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu_torch import aot, cli
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.eval import run_wider as TRW
from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.serve import BatchingDetector
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_cli import GOLDEN, _dumps, golden_tree  # noqa: F401
from tests.test_torch_port_eval import _image, _read_dump, _sorted, predictors, val_tree  # noqa: F401
from tests.test_torch_port_letterbox import parent_letterbox

CPU2 = ["--device", "cpu,cpu"]


@pytest.fixture(autouse=True)
def float32_presets(monkeypatch):
    for mod in (JC, TC):
        get = mod.get_model_config
        monkeypatch.setattr(mod, "get_model_config",
                            lambda name, get=get: dataclasses.replace(get(name), compute_dtype="float32"))


def jax_mesh(n=2):
    return JMesh(np.asarray(jax.devices()[:n]), ("data",))


@pytest.fixture(scope="module")
def mesh_predictors(predictors):  # noqa: F811
    """(JAX Predictor on 2 devices, port Predictor on [cpu, cpu], port
    single-replica Predictor), the same trained weights."""
    jpred, tpred = predictors
    jmesh = JPredictor(jpred.mcfg, jpred.variables, jpred.pcfg, use_pallas=False, fold_bn=False, mesh=jax_mesh())
    state = tpred.model.state_dict()
    tmesh = Predictor(tpred.mcfg, state, tpred.pcfg, fold_bn=False, mesh=M.make_mesh(["cpu", "cpu"]))
    return jmesh, tmesh, tpred


def test_mesh_predictor_keeps_one_replica_per_entry(mesh_predictors):
    _, tmesh, _ = mesh_predictors
    assert len(tmesh.replicas) == 2 and tmesh.replicas[0] is tmesh.model
    assert tmesh.replicas[1] is not tmesh.model
    for a, b in zip(tmesh.replicas[0].state_dict().values(), tmesh.replicas[1].state_dict().values()):
        assert torch.equal(a, b)


def test_detect_preprocessed_over_the_mesh_matches_jax_and_one_replica(mesh_predictors):
    jmesh, tmesh, tpred = mesh_predictors
    rng = np.random.default_rng(3)
    x = np.stack([cv2.resize(_image(s), (96, 96)).astype(np.float32) - 110.0 for s in ("img_0", "img_1", "img_2", "img_0")])
    x[3] = rng.normal(0, 40, x[3].shape)
    dets, valid = (t.numpy() for t in tmesh.detect_preprocessed(x))
    one_d, one_v = (t.numpy() for t in tpred.detect_preprocessed(x))
    jd, jv = (np.asarray(t) for t in jmesh.detect_preprocessed(x))
    assert dets.shape == jd.shape and valid.sum() > 0
    # Each replica runs the whole graph on its two rows: the same masks as
    # one replica on four, and the rows agree to float32 rounding (observed
    # 0 on this fixture); JAX's mesh rows within its float32 (observed
    # max 1.5e-5).
    np.testing.assert_array_equal(valid, one_v)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_allclose(dets[valid], one_d[valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dets[valid], jd[valid], atol=1e-4, rtol=0)


def test_detect_images_over_the_mesh_matches_jax(mesh_predictors):
    jmesh, tmesh, tpred = mesh_predictors
    rng = np.random.default_rng(4)
    images = [_image("img_0"), _image("img_1")[:80, :70], _image("img_2"),
              rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)]
    got, want, one = tmesh.detect_images(images), jmesh.detect_images(images), tpred.detect_images(images)
    assert [len(g) for g in got] == [len(w) for w in want] == [len(o) for o in one]
    assert sum(map(len, got)) > 0
    for g, w, o in zip(got, want, one):
        # the tolerances of test_torch_port_eval.py's detect_images (bfloat16
        # resample on both sides); observed max 3.1e-5 px against JAX, 0 to
        # the single replica
        np.testing.assert_allclose(_sorted(g), _sorted(np.asarray(w)), atol=0.05, rtol=1e-4)
        np.testing.assert_allclose(_sorted(g), _sorted(o), atol=1e-4, rtol=0)


def test_detect_images_over_the_mesh_letterboxes_bit_for_bit(mesh_predictors, monkeypatch):
    """Each replica's bucket, made on its device from its rows' own bytes,
    and its taps give the frames of the dense recipe the taps replaced
    (tests/test_torch_port_letterbox.py::parent_letterbox) to the bit; the
    detections equal the single replica's."""
    _, tmesh, tpred = mesh_predictors
    rng = np.random.default_rng(6)
    images = [_image("img_1"), _image("img_2")[:70, :90], rng.integers(0, 256, (50, 120, 3), dtype=np.uint8),
              _image("img_0")]
    frames = []
    letterbox = I.letterbox_batch_device

    def keep(*args, **kwargs):
        frames.append(letterbox(*args, **kwargs))
        return frames[-1]

    monkeypatch.setattr(I, "letterbox_batch_device", keep)
    got = tmesh.detect_images(images)
    assert [f.shape[0] for f in frames] == [2, 2]
    bucket = tuple(-(-max(im.shape[d] for im in images) // 128) * 128 for d in (0, 1))
    assert torch.equal(torch.cat(frames), parent_letterbox(images, tpred.pcfg.input_shape, bucket))
    one = tpred.detect_images(images)
    assert sum(map(len, got)) > 0
    for g, o in zip(got, one):  # observed 0
        np.testing.assert_allclose(_sorted(g), _sorted(o), atol=1e-4, rtol=0)


def test_indivisible_batch_raises_and_a_mesh_of_one_is_plain(mesh_predictors):
    _, tmesh, tpred = mesh_predictors
    x = np.zeros((3, 96, 96, 3), np.float32)
    with pytest.raises(ValueError, match="must divide the serving mesh size 2"):
        tmesh.detect_preprocessed(x)
    with pytest.raises(ValueError, match="must divide the serving mesh size 2"):
        tmesh.detect_images([_image("img_0")] * 3)
    one = Predictor(tpred.mcfg, tpred.model.state_dict(), tpred.pcfg, fold_bn=False, mesh=M.make_mesh(["cpu"]))
    assert one.mesh is None and len(one.replicas) == 1
    a, b = one.detect_preprocessed(x), tpred.detect_preprocessed(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # partition="spatial" without a mesh of size > 1 is the plain path too
    # (tests/test_torch_port_spatial.py holds it over a mesh).
    for mesh in (None, M.make_mesh(["cpu"])):
        sp = Predictor(tpred.mcfg, tpred.model.state_dict(), tpred.pcfg, fold_bn=False, device="cpu", mesh=mesh,
                       partition="spatial")
        assert sp.mesh is None and sp.partition == "spatial"
        assert all(torch.equal(u, v) for u, v in zip(sp.detect_preprocessed(x), b))
    with pytest.raises(ValueError, match="partition must be"):
        Predictor(tpred.mcfg, tpred.model.state_dict(), tpred.pcfg, device="cpu", partition="height")


def test_make_mesh_for_batch_shrinks_as_jax_does():
    from jabd_tpu.parallel import mesh as JM

    for b in range(1, 17):
        assert M.make_mesh_for_batch(b, ["cpu"] * 8).size == JM.make_mesh_for_batch(b).size, b
    assert M.make_mesh(["cpu", "cpu"]).devices == [torch.device("cpu")] * 2


def test_sweep_over_the_mesh_matches_jax_dumps(mesh_predictors, val_tree, tmp_path):  # noqa: F811
    """8 images in chunks of 4 (JAX pads nothing here); the port's mesh
    pads a short chunk itself (batch 6: a chunk of 2)."""
    jmesh, tmesh, _ = mesh_predictors
    JRW.run_wider_val(jmesh, val_tree, batch_size=4, out_dir=str(tmp_path / "jax"), num_workers=2)
    TRW.run_wider_val(tmesh, val_tree, batch_size=4, out_dir=str(tmp_path / "port"), num_workers=2)
    TRW.run_wider_val(tmesh, val_tree, batch_size=6, out_dir=str(tmp_path / "port6"), num_workers=2)
    jd, td, t6 = (_read_dump(str(tmp_path / d)) for d in ("jax", "port", "port6"))
    assert jd.keys() == td.keys() == t6.keys() and len(td) == 8
    assert sum(n for _, n, _ in td.values()) > 0
    for key, (header, n, rows) in jd.items():
        # test_torch_port_eval.py's single-scale bound (uint8 letterbox, 1
        # grey level): observed max 0.014 px
        assert td[key][:2] == (header, n) == t6[key][:2], key
        np.testing.assert_allclose(td[key][2], rows, atol=0.05, rtol=0)
        np.testing.assert_allclose(t6[key][2], td[key][2], atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="must divide the serving mesh size"):
        TRW.run_wider_val(tmesh, val_tree, batch_size=3)


def test_artifact_over_the_mesh_equals_live(mesh_predictors, tmp_path):
    _, tmesh, tpred = mesh_predictors
    out = aot.export_detector(tpred, str(tmp_path / "art"), batch_size=2)
    det = aot.load_exported(out, mesh=M.make_mesh(["cpu", "cpu"]))
    assert det.batch_size == 4 and len(det._fns) == 2
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 40, (4, 96, 96, 3))).astype(np.float32)
    x[:3] = np.stack([cv2.resize(_image(s), (96, 96)).astype(np.float32) - 110.0 for s in ("img_0", "img_1", "img_2")])
    got = [t.numpy() for t in det.detect_preprocessed(x)]
    want = [t.numpy() for t in tmesh.detect_preprocessed(x)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0][got[1]], want[0][want[1]], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="exported for batch 4"):
        det.detect_preprocessed(x[:2])
    assert len(det.detect_image(_image("img_0"))) == len(tpred.detect_image(_image("img_0")))
    emb = aot.load_exported(out, device="cpu", mesh=M.make_mesh(["cpu"]))
    assert emb.batch_size == 2 and emb.mesh is None


def test_batching_detector_checks_the_mesh(mesh_predictors):
    _, tmesh, tpred = mesh_predictors
    with pytest.raises(ValueError, match="batch size 3 must divide the serving mesh size 2"):
        BatchingDetector(tmesh, batch_size=3)
    det = BatchingDetector(tmesh, batch_size=4, max_wait_ms=50)
    try:
        img = _image("img_1")
        out = [None] * 4
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, det.detect(img))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        want = tpred.detect_image(img)
        assert len(want)
        for o in out:  # observed 0
            np.testing.assert_allclose(o, want, atol=1e-3, rtol=0)
    finally:
        det.close()


def test_cli_map_txt_data_parallel_matches_jax(golden_tree, tmp_path):  # noqa: F811
    weights, val_dir = golden_tree["pth"], golden_tree["val"]
    common = ["--model", GOLDEN, "--weights", weights, "--input-size", "96", "--confidence", "0.5",
              "--batch-size", "2", "--data-parallel"]
    JCLI.main(["map-txt", *common, "--val-dir", val_dir, "--out", str(tmp_path / "jax")])
    cli.main(["map-txt", *common, "--val-dir", val_dir, "--out", str(tmp_path / "port"), *CPU2])
    cli.main(["map-txt", *common[:-1], "--val-dir", val_dir, "--out", str(tmp_path / "plain"), "--device", "cpu"])
    jd, td, pd = (_dumps(str(tmp_path / d)) for d in ("jax", "port", "plain"))
    assert jd.keys() == td.keys() == pd.keys() and jd
    for key, (header, n, rows) in jd.items():
        assert td[key][:2] == (header, n) == pd[key][:2], key
        # test_torch_port_cli.py's map-txt bounds: observed max 0.010 px
        np.testing.assert_allclose(td[key][2][:, :4], rows[:, :4], atol=0.05, rtol=0)
        np.testing.assert_allclose(td[key][2][:, 4], rows[:, 4], atol=5e-3, rtol=0)
        np.testing.assert_allclose(td[key][2], pd[key][2], atol=1e-3, rtol=0)


def test_cli_dir_predict_data_parallel(golden_tree, tmp_path, capsys):  # noqa: F811
    weights, val_dir = golden_tree["pth"], golden_tree["val"]
    event = sorted(e for e in os.listdir(val_dir) if os.path.isdir(os.path.join(val_dir, e)))[0]
    common = ["--model", GOLDEN, "--weights", weights, "--input-size", "96", "--confidence", "0.5",
              "--input-dir", os.path.join(val_dir, event), "--batch-size", "2"]
    JCLI.main(["dir-predict", *common, "--data-parallel", "--out", str(tmp_path / "jax")])
    want = capsys.readouterr().out
    cli.main(["dir-predict", *common, "--data-parallel", "--out", str(tmp_path / "port"), *CPU2])
    got = capsys.readouterr()
    assert "[mesh] serving sharded over 2 devices" in got.err
    counts = lambda text: sorted(line for line in text.splitlines() if line.split(" ")[-1].isdigit())  # noqa: E731
    assert counts(got.out) == counts(want) and counts(got.out)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_cli_serve_data_parallel_live_and_exported(golden_tree, tmp_path, monkeypatch):  # noqa: F811
    """`serve --data-parallel` (live, and over an artifact) hands serve()
    a BatchingDetector over a 2-entry mesh; a request through each answers
    what the CLI's own single-device Predictor's detect_image answers, and
    what `jabd_tpu.cli serve --data-parallel`'s BatchingDetector answers."""
    from jabd_tpu_torch import serve as S

    common = ["--model", GOLDEN, "--weights", golden_tree["pth"], "--input-size", "96", "--confidence", "0.5"]
    cli.main(["export", *common, "--out", str(tmp_path / "art"), "--batch-size", "1", "--platforms", "cpu",
              "--device", "cpu"])
    seen = []
    monkeypatch.setattr(S, "serve", lambda det, **kw: seen.append(det))
    cli.main(["serve", *common, "--batch-size", "2", "--data-parallel", *CPU2])
    cli.main(["serve", "--exported", str(tmp_path / "art"), "--batch-size", "2", "--data-parallel", *CPU2])
    assert len(seen) == 2
    from jabd_tpu import serve as JS

    jseen = []
    monkeypatch.setattr(JS, "serve", lambda det, **kw: jseen.append(det))
    JCLI.main(["serve", *common, "--batch-size", "2", "--data-parallel"])
    img = _image("img_1")
    try:
        assert jseen[0].backend.mesh.size == 2
        jax_dets = np.asarray(jseen[0].detect(img))
    finally:
        jseen[0].close()
    ref = cli._load_predictor(cli.build_parser().parse_args(["predict", "--image", "x", *common, "--device", "cpu"]))
    want = ref.detect_image(img)
    assert len(want) and jax_dets.shape == want.shape
    for det in seen:
        try:
            assert det.backend.mesh.size == 2 and det.batch_size == 2
            got = det.detect(img)
            # the folded float32 graph either way: observed 0 to the port's
            # own detect_image; JAX's daemon over its 2-device mesh within
            # test_torch_port_cli.py's map-txt bounds
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
            np.testing.assert_allclose(got[:, :4], jax_dets[:, :4], atol=0.05, rtol=0)
            np.testing.assert_allclose(got[:, 4], jax_dets[:, 4], atol=5e-3, rtol=0)
        finally:
            det.close()


@pytest.mark.parametrize(
    "argv,message",
    [
        (["predict", "--image", "{image}", "--out", "{out}/p.jpg", "--spatial", *CPU2], None),
        (["serve", "--spatial", "--data-parallel"], "mutually exclusive"),
        (["map-txt", "--val-dir", ".", "--out", "o", "--spatial", "--data-parallel"], "mutually exclusive"),
        (["serve", "--device", "cpu,cpu"], "need --data-parallel"),
    ],
)
def test_spatial_and_mesh_flag_exits(argv, message, golden_tree, tmp_path, capsys):  # noqa: F811
    """The flags' exits; `predict --spatial` over [cpu, cpu] (message
    None) now runs and finds the faces one device finds."""
    if message is None:
        argv = [a.format(image=golden_tree["image"], out=tmp_path) for a in argv]
        common = ["--weights", golden_tree["pth"], "--model", GOLDEN, "--input-size", "96"]
        cli.main(argv + common)
        got = capsys.readouterr().out
        cli.main(argv[: argv.index("--spatial")] + common + ["--device", "cpu"])
        want = capsys.readouterr().out
        assert "faces" in got and got.splitlines()[0] == want.splitlines()[0]
        return
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)
