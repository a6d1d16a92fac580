"""PyTorch port, the learning proofs (scripts/torch_*.py and their shared
data generators, scripts/_torch_synthetic.py) against the JAX package's scripts
(scripts/overfit_*.py, train_at_scale.py, train_recognition_at_scale.py),
loaded by file path, on the CPU at small sizes:

* the synthetic data generators give the JAX scripts' arrays, label lines and
  ground truth at the same seeds (the at-scale tree's JPEGs, PIL here and
  cv2 there, within a stated pixel bound);
* the first 3 steps of the detector overfit at 64x64, batch 2, from the
  JAX init carried across by utils/convert.py, lose what the JAX loop
  loses on the JAX script's batches;
* the recall counter and the separation metrics compute what the JAX
  scripts compute on the same detections and embeddings;
* every twin runs end to end at a tiny size with --device cpu (the
  learning asserts off under the JAX scripts' own smoke rules; the two
  int8 reports in test_torch_port_learning_int8.py, whose int8 sites run
  slowly on the CPU), and raises without a card when no device is given.
"""

import dataclasses
import functools
import importlib.util
import io
import os
import re
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import losses as JL
from jabd_tpu import train as JT
from jabd_tpu.ops import anchors as JA
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.eval.run_wider import decode_bgr
from jabd_tpu_torch.eval.wider_eval import load_gt_mats
from jabd_tpu_torch.recognition import train as RT
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from scripts import _torch_synthetic as syn
from scripts import torch_int8_ap_delta, torch_int8_verification_delta, torch_overfit_device_augment
from scripts import torch_overfit_recognition, torch_overfit_sanity, torch_resume_at_scale
from scripts import torch_train_at_scale, torch_train_recognition_at_scale
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_eval import _fake_gt_dir

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _jax_script(name):
    """A JAX-package script loaded by file path, as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


# -- (a) the data generators ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_batch_is_the_jax_scripts(seed):
    js = _jax_script("overfit_sanity")
    want = js.make_batch(np.random.default_rng(seed), 16)
    got = syn.make_batch(np.random.default_rng(seed), 16)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()


def test_identity_renders_are_the_jax_scripts():
    jo = _jax_script("overfit_recognition")
    ja = _jax_script("train_recognition_at_scale")
    bases = [syn.identity_base(i) for i in range(jo.IDS)]
    for i in (0, 5, 15):
        assert syn.identity_base(i).tobytes() == jo.identity_base(i).tobytes() == ja.identity_base(i).tobytes()
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for i in (0, 7, 15):
        w, g = jo.render(i, r1), syn.render_float(bases[i], r2)
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
        w, g = ja.render(bases[i], r1), syn.render(bases[i], r2)
        assert w.dtype == g.dtype == np.uint8 and w.tobytes() == g.tobytes()
    jo.BS = 8
    w_imgs, w_labels = jo.make_batch(np.random.default_rng(4))
    g_imgs, g_labels = syn.make_identity_batch(np.random.default_rng(4), bases, 8)
    assert w_imgs.tobytes() == g_imgs.tobytes() and np.array_equal(w_labels, g_labels)


def test_identity_tree_and_val_bundle_are_the_jax_scripts(tmp_path, monkeypatch):
    ja = _jax_script("train_recognition_at_scale")
    monkeypatch.setattr(ja, "IDS", 3)
    monkeypatch.setattr(ja, "PER_ID", 2)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    wb = ja.build_identity_tree(str(tmp_path / "jax"), r1)
    gb = syn.build_identity_tree(str(tmp_path / "port"), r2, 3, 2)
    assert all(w.tobytes() == g.tobytes() for w, g in zip(wb, gb))
    for rel in ("id_000/0.jpg", "id_002/1.jpg"):
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()
    ja.build_val_bundle(str(tmp_path / "jv"), wb, r1, pairs=5)
    syn.build_val_bundle(str(tmp_path / "pv"), gb, r2, pairs=5)
    for rel in ("lfw/memfile/lfw.npy", "lfw_list.npy"):
        assert np.array_equal(np.load(tmp_path / "jv" / rel), np.load(tmp_path / "pv" / rel))


def test_device_augment_tree_is_the_jax_scripts(tmp_path):
    jd = _jax_script("overfit_device_augment")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    want = jd.build_dataset(str(tmp_path / "jax"), 6, r1)
    got = syn.build_dataset(str(tmp_path / "port"), 6, r2)
    assert open(want).read() == open(got).read()
    for i in range(6):
        rel = os.path.join("images", f"img_{i}.jpg")
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()
    assert r1.integers(1 << 30) == r2.integers(1 << 30)  # the streams stay in step


# The port writes the at-scale tree with PIL, the JAX script with cv2, both
# at quality 95 with 4:2:0 chroma. Two libjpeg builds may round otherwise;
# with PIL 12.1 and cv2 5.0 the decoded pixels are equal (observed 0).
TREE_MAX_DIFF, TREE_MEAN_DIFF = 8, 0.25


def test_at_scale_tree_is_the_jax_scripts(tmp_path):
    import cv2

    jt = _jax_script("train_at_scale")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    wpath, wgt = jt.build_tree(str(tmp_path / "jax"), 5, r1, src_scale=0.5)
    gpath, ggt = syn.build_tree(str(tmp_path / "port"), 5, r2, src_scale=0.5)
    assert open(wpath).read() == open(gpath).read()
    assert wgt == ggt
    for i in range(5):
        rel = os.path.join("images", f"img_{i}.jpg")
        want = cv2.imread(str(tmp_path / "jax" / rel)).astype(int)
        got = decode_bgr(str(tmp_path / "port" / rel)).astype(int)
        assert want.shape == got.shape
        diff = np.abs(want - got)
        assert diff.max() <= TREE_MAX_DIFF and diff.mean() <= TREE_MEAN_DIFF, (i, diff.max(), diff.mean())


def test_gt_mats_are_the_jax_tests(tmp_path):
    events = {"0--Scale": {"img_0": [[1, 2, 30, 30], [40, 5, 28, 28]], "img_1": [[3, 4, 50, 50]]},
              "1--Other": {"img_9": [[7, 8, 9, 10]]}}
    (tmp_path / "jax").mkdir()
    want = load_gt_mats(str(_fake_gt_dir(tmp_path / "jax", events)))
    got = load_gt_mats(syn.write_gt_mats(str(tmp_path / "port"), events))
    boxes_w, events_w, files_w, settings_w = want
    boxes_g, events_g, files_g, settings_g = got
    for e in range(len(events)):
        assert str(events_w[e, 0][0]) == str(events_g[e, 0][0])
        for j in range(len(files_w[e, 0])):
            assert str(files_w[e, 0][j, 0][0]) == str(files_g[e, 0][j, 0][0])
            assert np.array_equal(boxes_w[e, 0][j, 0], boxes_g[e, 0][j, 0])
            for s in ("easy", "medium", "hard"):
                assert np.array_equal(settings_w[s][e, 0][j, 0], settings_g[s][e, 0][j, 0])


# -- (b) the first steps of the detector overfit ----------------------------


def test_overfit_steps_match_the_jax_loop(monkeypatch):
    """3 steps of the JAX script's loop (its make_batch at 64x64, batch 2)
    and of the port's `train_steps`, from the JAX init (PRNGKey(0), the
    reference init) carried across, in float32, and the port's in float64
    beside them.

    The first step's loss is held to test_torch_port_train.py's tolerance
    of one step, rtol 1e-5 (observed 1.7e-6). Adam's first update moves
    each weight by lr * sign(g + wd * p): a component of the gradient near
    0 lands on either side by rounding, and the JAX package's float32
    gradients lie furthest from float64 (flax's BatchNorm variance, ROADMAP
    section 3), so after one step 11,646 of 2,596,048 weights (0.45%) sit
    2 lr apart from the port's float32 ones and 11,394 from its float64
    ones. The next losses then spread by float32 rounding amplified, as far
    between the port's own float32 and float64 runs as between either and
    JAX (observed: port f32 against JAX 6.2e-4 / 7.4e-4 at steps 2 / 3,
    port f64 against JAX 4.2e-4 / 1.5e-3, port f32 against f64 2.0e-4 /
    2.3e-3): steps 2 and 3 are held at rtol 1e-2, each run to each."""
    js = _jax_script("overfit_sanity")
    monkeypatch.setattr(js, "SIZE", 64)
    size, bs, g = 64, 2, js.G
    jcfg = dataclasses.replace(JC.get_model_config("mnet_v3_plain"), compute_dtype="float32")
    jtcfg = JC.TrainConfig(batch_size=bs, image_size=size, max_targets=g, lr_freeze=1e-3)
    state = JT.create_train_state(jax.random.PRNGKey(0), jcfg, jtcfg, steps_per_epoch=10_000, image_size=size)
    init = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    step = JT.make_train_step(jcfg, jtcfg)
    anchors = JA.generate_anchors(jcfg.anchors, (size, size)).copy()
    rng = np.random.default_rng(0)
    want = []
    for _ in range(3):
        imgs, boxes, valid = js.make_batch(rng, bs)
        targets = JL.Targets(jnp.asarray(boxes), jnp.ones((bs, g)), jnp.zeros((bs, g, 10)), jnp.asarray(valid))
        state, m = step(state, jnp.asarray(imgs), targets, jnp.asarray(anchors))
        want.append(float(m["loss"]))

    tcfg = dataclasses.replace(TC.get_model_config("mnet_v3_plain"), compute_dtype="float32")
    ttcfg = TC.TrainConfig(batch_size=bs, image_size=size, max_targets=g, lr_freeze=1e-3)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        tstate = TT.create_train_state(tcfg, ttcfg, steps_per_epoch=10_000, device="cpu")
        tstate.model.load_state_dict(state_dict_from_flax(init))
        tstate.model.to(dtype)
        tstate.optimizer = TT.make_optimizer(tstate.model.parameters(), 1e-3)
        _, losses = torch_overfit_sanity.train_steps(
            tstate, TT.make_train_step(tcfg, ttcfg), torch.from_numpy(anchors).to(dtype), np.random.default_rng(0),
            3, size=size, bs=bs, g=g,
        )
        runs[dtype] = [float(x) for x in losses]
    got = runs[torch.float32]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in ((got, want), (runs[torch.float64], want), (got, runs[torch.float64])):
        np.testing.assert_allclose(a, b, rtol=1e-2)
    assert want[-1] < want[0] and got[-1] < got[0]  # both loops learn from their first steps


# -- (c) the recall counter and the separation metrics ----------------------


def _stub_train(**attrs):
    return types.SimpleNamespace(**attrs)


def test_recall_counter_is_the_jax_scripts(monkeypatch):
    """The JAX script's main with its training and model stubbed and
    `detect_batch` returning chosen detections of its own eval canvases:
    hits, near misses (IoU < 0.5), invalid rows and images without
    detections. The port's counter gives its recall on the same rows."""
    js = _jax_script("overfit_sanity")
    seed, size, g = 0, js.SIZE, js.G
    _, boxes, valid = syn.make_batch(np.random.default_rng(seed), 16, size, g)
    rng = np.random.default_rng(7)
    dets = np.zeros((16, 32, 15), np.float32)
    dvalid = np.zeros((16, 32), bool)
    for i in range(16):
        if i % 5 == 4:
            continue  # no detections in this image
        for j, box in enumerate(boxes[i][valid[i]]):
            shift = 0.01 if (i + j) % 3 else 0.12  # a hit, or a miss at IoU < 0.5
            dets[i, j, :4] = box + shift * np.asarray([1, 1, 1, 1]) * (1 + rng.random())
            dvalid[i, j] = True
        dets[i, 10, :4] = boxes[i, 0]  # an exact box on an invalid row
    monkeypatch.setattr(js, "train", _stub_train(
        create_train_state=lambda *a, **k: _stub_train(params=None, batch_stats=None),
        make_train_step=lambda *a, **k: None,
    ))
    monkeypatch.setattr(js, "build_model", lambda *a, **k: _stub_train(apply=lambda *a, **k: None))
    monkeypatch.setattr(js, "detect_batch", lambda *a, **k: (dets, dvalid))
    with redirect_stdout(io.StringIO()):
        want = js.main(steps=0, seed=seed)
    gt = [boxes[i][valid[i]] * size for i in range(16)]
    tp, total_gt, total_det = torch_overfit_sanity.recall_counts(dets, dvalid, gt, size)
    assert tp / total_gt == want
    assert 0 < want < 1 and total_det == int(dvalid.sum())


def test_separation_metrics_are_the_jax_scripts(monkeypatch):
    """The JAX script's main for 2 stubbed steps (losses 10 then 1, acc
    0.99) with chosen embeddings of its 16 x 8 fresh renders: its printed
    cosines and 1-NN accuracy (3 decimals) and its verdict against the
    port's `separation` and `passed`, once for separated embeddings and
    once for mixed ones."""
    jo = _jax_script("overfit_recognition")
    labels = np.repeat(np.arange(jo.IDS), 8)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(jo.IDS, 512))
    for spread, expect in ((0.4, True), (3.0, False)):
        emb = centers[labels] + spread * rng.normal(size=(len(labels), 512))
        emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
        metrics = iter([{"loss": 10.0, "acc": 0.5}, {"loss": 1.0, "acc": 0.99}])
        monkeypatch.setattr(jo, "rtrain", _stub_train(
            create_state=lambda *a, **k: _stub_train(params={"model": None}, batch_stats={"model": None}),
            make_train_step=lambda *a, **k: lambda state, *b: (state, next(metrics)),
        ))
        monkeypatch.setattr(jo, "net", _stub_train(build_model=lambda *a, **k: None))
        monkeypatch.setattr(jo, "heads", _stub_train(build_head=lambda *a, **k: None))
        monkeypatch.setattr(jo, "make_batch", lambda r: (np.zeros((1, 112, 112, 3)), np.zeros(1, int)))
        monkeypatch.setattr(jo, "jax", _stub_train(
            random=jax.random, jit=lambda f: (lambda v, x: (jnp.asarray(emb), None))))
        out = io.StringIO()
        with redirect_stdout(out):
            ok = jo.main(steps=2)
        printed = [float(v) for v in re.findall(r"-?\d+\.\d+", out.getvalue().split("fresh-render separation:")[1]
                                                   .splitlines()[0])]
        sep = torch_overfit_recognition.separation(emb, labels)
        want = dict(zip(("genuine_mean", "genuine_min", "impostor_mean", "impostor_max", "nn_acc"), printed))
        for k, v in want.items():
            assert abs(sep[k] - v) <= 5e-4, (k, sep[k], v)
        assert bool(ok) == torch_overfit_recognition.passed(10.0, 1.0, 0.99, sep) == expect


# -- (d) every twin end to end at a tiny size -------------------------------


def test_overfit_scripts_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch_overfit_sanity, "SIZE", 64)
    monkeypatch.setattr(torch_overfit_sanity, "BS", 2)
    recall = torch_overfit_sanity.main(steps=2, device="cpu")
    assert 0.0 <= recall <= 1.0
    monkeypatch.setattr(torch_overfit_device_augment, "SIZE", 64)
    monkeypatch.setattr(torch_overfit_device_augment, "BS", 2)
    monkeypatch.setattr(torch_overfit_device_augment, "IMAGES", 4)
    recall = torch_overfit_device_augment.main(steps=3, device="cpu")  # crosses an epoch
    assert 0.0 <= recall <= 1.0


def test_recognition_overfit_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch_overfit_recognition, "BS", 4)
    monkeypatch.setattr(torch_overfit_recognition, "IDS", 4)
    with pytest.raises(ValueError, match="increase strictly"):
        torch_overfit_recognition.main(steps=2, device="cpu")  # (1, 1): the check stands
    assert torch_overfit_recognition.main(steps=2, device="cpu", milestones=(1, 2)) in (True, False)


def test_train_at_scale_then_resume_on_the_cpu(tmp_path):
    root = str(tmp_path / "scale")
    common = ["--batch", "4", "--size", "64", "--model", "mnet_v3_plain", "--device", "cpu"]
    out = torch_train_at_scale.main(["--steps", "8", "--images", "8", "--src-scale", "0.4", "--keep",
                                     "--root", root] + common)
    # 2 steps an epoch, 4 epochs, interrupted after 2.
    assert (out["total_epochs"], out["mid_epochs"]) == (4, 2)
    assert out["state_step"] == out["expect_steps"] == 8
    assert out["phase_b_epochs"] == 2 and len(out["losses"]) == 4
    assert set(out["aps"]) == {"easy", "medium", "hard"}
    assert all(0.0 <= v <= 1.0 for v in out["aps"].values())
    assert sorted(os.listdir(os.path.join(root, "ckpt"))) == ["1.pt", "2.pt", "3.pt", "4.pt"]
    # A fresh call continues the kept run from epoch 4 to 5.
    more = torch_resume_at_scale.main([root, "--steps", "10"] + common)
    assert more["resumed_from"] == 4 and more["state_step"] == more["expect_steps"] == 10
    assert len(more["losses"]) == 5 and os.path.isdir(os.path.join(root, "val2"))


def test_loss_history_of_fit_calls_in_one_second_stay_apart(tmp_path, monkeypatch):
    """Two fit calls in the same second (a resume of a short phase) each
    get their own loss log, the later one sorting last, so the resume
    discriminator reads phase B's epochs alone; before, they shared a
    directory and phase B's file held both phases."""
    import time

    from jabd_tpu_torch.utils import logging as TLog

    strftime = time.strftime
    monkeypatch.setattr(TLog.time, "strftime", lambda fmt, *a: strftime(fmt, time.gmtime(0)))
    a = TLog.LossHistory(str(tmp_path))
    b = TLog.LossHistory(str(tmp_path))
    a.plot = b.plot = False
    a.append_loss(3.0)
    b.append_loss(2.0)
    assert a.save_path != b.save_path
    newest = sorted(os.listdir(tmp_path))[-1]
    assert open(os.path.join(tmp_path, newest, "epoch_loss.txt")).read().split() == ["2.0"]


@pytest.fixture
def small_validation(monkeypatch):
    """Validation in batches of 16 in place of 256: the padded tail is
    dropped either way, so the accuracies are the same, at a sixteenth of
    the CPU time."""
    monkeypatch.setattr(RT, "validate_5sets", functools.partial(RT.validate_5sets, batch_size=16))


@pytest.mark.parametrize("flags", [[], ["--device-augment", "--shard-head"]])
def test_train_recognition_at_scale_on_the_cpu(flags, small_validation):
    out = torch_train_recognition_at_scale.main(
        ["--epochs", "2", "--batch", "8", "--ids", "4", "--per-id", "4", "--val-pairs", "5", "--device", "cpu"]
        + flags
    )
    assert out["state_step"] == 4 and out["b_epochs"] == 1
    assert out["rows"][0] == "epoch,step,loss,acc,val_acc" and len(out["rows"]) == 3
    assert [r.split(",")[:2] for r in out["rows"][1:]] == [["1", "2"], ["2", "4"]]
    assert 0.0 <= out["best"]["val_acc"] <= 1.0 and out["best"]["epoch"] in (1, 2)


@pytest.mark.parametrize("run", [
    lambda: torch_overfit_sanity.main(steps=1),
    lambda: torch_overfit_device_augment.main(steps=1),
    lambda: torch_overfit_recognition.main(steps=10),
    lambda: torch_train_at_scale.main([]),
    lambda: torch_resume_at_scale.main(["unused"]),
    lambda: torch_train_recognition_at_scale.main([]),
    lambda: torch_int8_ap_delta.main([]),
    lambda: torch_int8_verification_delta.main([]),
], ids=["overfit_sanity", "overfit_device_augment", "overfit_recognition", "train_at_scale",
        "resume_at_scale", "train_recognition_at_scale", "int8_ap_delta", "int8_verification_delta"])
def test_scripts_raise_without_a_card(run):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
