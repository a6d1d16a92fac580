"""PyTorch port, the command line (cli.py), on the CPU (`--device cpu`):

- the flags reach TrainConfig and PredictConfig, as tests/test_cli_args.py
  checks for the JAX package;
- `map-txt` (one image at a time, and the batched sweep) writes the JAX
  package's `cmd_map_txt` dumps on the trained golden fixture, given as a
  reference-named `.pth`, within test_torch_port_eval.py's tolerances;
  `eval` gives JAX's APs on them;
- `export-pth` -> `predict --weights` round-trips, and `predict` counts
  the JAX CLI's faces on the same `.pth`;
- `dir-predict` (padded tail batch), `video` on a 3-frame MJPG clip,
  `count`, and an artifact through `export` and `predict --exported`;
- the parallel flags and recognition training exit naming their slice.

Both CLIs build the presets in float32 here (their `get_model_config`
patched), so the comparison is of the algorithm, not of bfloat16 rounding.
"""

import dataclasses
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from jabd_tpu import cli as JCLI
from jabd_tpu import configs as JC
from jabd_tpu import train as JT
from jabd_tpu_torch import cli
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.eval.run_wider import decode_bgr
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.utils.np_ckpt import load_variables_npz
from jabd_tpu_torch.utils.torch_convert import export_state_dict_auto, load_pth, save_pth
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_eval import _fake_gt_dir
from tests.test_golden_e2e import FIXTURE_DIR

GOLDEN = "retinaface_mnet025"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def float32_presets(monkeypatch):
    for mod in (JC, TC):
        get = mod.get_model_config
        monkeypatch.setattr(mod, "get_model_config",
                            lambda name, get=get: dataclasses.replace(get(name), compute_dtype="float32"))


@pytest.fixture(scope="module")
def golden_tree(tmp_path_factory):
    """The golden fixture as a reference-named .pth, its PNGs as a WIDER
    val tree (named .jpg, as the evaluator's reader wants) and its GT mats."""
    root = tmp_path_factory.mktemp("golden")
    cfg = TC.get_model_config(GOLDEN)
    state = load_variables_npz(os.path.join(FIXTURE_DIR, "ckpt_mnet025_96.npz"),
                               build_model(cfg, device="cpu").state_dict())
    pth = str(root / "golden.pth")
    save_pth(export_state_dict_auto(state, cfg), pth)
    golden = np.load(os.path.join(FIXTURE_DIR, "golden.npz"))
    val = root / "val" / "0--Golden"
    val.mkdir(parents=True)
    gts = {}
    for s in ("img_0", "img_1", "img_2"):
        shutil.copy(os.path.join(FIXTURE_DIR, "images", s + ".png"), val / (s + ".jpg"))
        gts[s] = golden["gt_" + s]
    gt_dir = root / "gt"
    gt_dir.mkdir()
    _fake_gt_dir(gt_dir, {"0--Golden": gts})
    return dict(pth=pth, val=str(root / "val"), gt=str(gt_dir), image=str(val / "img_1.jpg"))


def _dumps(root):
    out = {}
    for event in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, event))):
            with open(os.path.join(root, event, name)) as f:
                lines = f.read().splitlines()
            out[(event, name)] = (lines[0], int(lines[1]), np.loadtxt(lines[2:], ndmin=2).reshape(-1, 5))
    return out


def _last_json(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_train_flags_reach_trainconfig(monkeypatch, tmp_path):
    (tmp_path / "images").mkdir()
    cv2.imwrite(str(tmp_path / "images" / "a.jpg"), np.zeros((32, 32, 3), np.uint8))
    label = tmp_path / "label.txt"
    label.write_text("# a.jpg\n4 4 8 8 " + " ".join(["-1"] * 15) + "\n")
    captured = {}

    def fake_fit(mcfg, tcfg, ds, log_dir=None, checkpoint_manager=None, device=None):
        captured.update(mcfg=mcfg, tcfg=tcfg, ds=ds, device=device, log_dir=log_dir,
                        ckpt=checkpoint_manager.directory)

    monkeypatch.setattr(TT, "fit", fake_fit)
    cli.main(["train", "--label-txt", str(label), "--model", "mnet_v3_plain", "--batch-size", "3",
              "--input-size", "128", "--epochs", "7", "--freeze-epochs", "2", "--microbatches", "2",
              "--save-period", "3", "--device-augment", "--matching-impl", "plain",
              "--ckpt-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "lg"), *CPU])
    t = captured["tcfg"]
    assert (t.batch_size, t.image_size, t.total_epochs, t.freeze_epochs, t.microbatches, t.save_period) == (
        3, 128, 7, 2, 2, 3)
    assert t.device_augment is True and t.matching_impl == "plain" and t.fsdp is False
    assert captured["mcfg"].name == "mnet_v3_plain" and len(captured["ds"]) == 1
    assert captured["device"] == "cpu" and captured["ckpt"] == str(tmp_path / "ck")
    # The defaults are the JAX CLI's.
    defaults = {}
    monkeypatch.setattr(JT, "fit", lambda mcfg, tcfg, ds, **kw: defaults.setdefault("jax", tcfg))
    monkeypatch.setattr(TT, "fit", lambda mcfg, tcfg, ds, **kw: defaults.setdefault("port", tcfg))
    JCLI.main(["train", "--label-txt", str(label), "--ckpt-dir", str(tmp_path / "j")])
    cli.main(["train", "--label-txt", str(label), "--ckpt-dir", str(tmp_path / "p")])
    for field in ("batch_size", "image_size", "total_epochs", "freeze_epochs", "save_period", "microbatches",
                  "device_augment", "matching_impl"):
        assert getattr(defaults["port"], field) == getattr(defaults["jax"], field), field
    with pytest.raises(SystemExit, match="--fsdp: the parallelism slice"):
        cli.main(["train", "--label-txt", str(label), "--fsdp"])
    with pytest.raises(SystemExit):
        cli.main(["train", "--label-txt", str(label), "--matching-impl", "pallas"])


def test_predict_flags_reach_predictconfig():
    args = cli.build_parser().parse_args(
        ["predict", "--image", "x.png", "--model", GOLDEN, "--confidence", "0.25", "--nms-iou", "0.4",
         "--input-size", "96", *CPU])
    pred = cli._load_predictor(args)
    assert (pred.pcfg.confidence, pred.pcfg.nms_iou, pred.pcfg.input_shape) == (0.25, 0.4, (96, 96))
    assert pred.device.type == "cpu" and pred.mcfg.compute_dtype == "float32"
    # The JAX CLI's defaults (jabd_tpu/cli.py::main, `common`).
    defaults = cli.build_parser().parse_args(["predict", "--image", "x"])
    assert (defaults.model, defaults.confidence, defaults.nms_iou, defaults.input_size) == (
        "jabd_flagship", 0.5, 0.3, 1280)


@pytest.mark.parametrize("batch", [1, 3])
def test_map_txt_and_eval_match_jax(golden_tree, tmp_path, capsys, batch):
    """Float32 on both sides; the uint8 letterbox rounds to whole grey
    levels (torch bilinear against cv2's fixed point, 1 grey level at
    most), so the bounds are test_torch_port_eval.py's for the single-scale
    sweep: 0.05 px and 5e-3. Observed: the same counts, max box diff
    0.010 px, score diff 1.3e-3 (both modes alike)."""
    outs = {}
    for name, main in (("jax", JCLI.main), ("port", cli.main)):
        out = str(tmp_path / name)
        argv = ["map-txt", "--weights", golden_tree["pth"], "--model", GOLDEN, "--input-size", "96",
                "--batch-size", str(batch), "--val-dir", golden_tree["val"], "--out", out]
        main(argv + (CPU if name == "port" else []))
        outs[name] = out
    want, got = _dumps(outs["jax"]), _dumps(outs["port"])
    assert set(got) == set(want) and len(got) == 3
    for key in want:
        (gh, gn, grows), (wh, wn, wrows) = got[key], want[key]
        assert gh == wh and gn == wn, key
        np.testing.assert_allclose(grows[:, :4], wrows[:, :4], rtol=0, atol=0.05)
        np.testing.assert_allclose(grows[:, 4], wrows[:, 4], rtol=0, atol=5e-3)
    capsys.readouterr()
    aps = {}
    for name, main in (("jax", JCLI.main), ("port", cli.main)):
        main(["eval", "--pred-dir", outs[name], "--gt-dir", golden_tree["gt"]])
        aps[name] = _last_json(capsys.readouterr().out)
    assert aps["port"] == aps["jax"] and 0 < aps["port"]["hard"] <= 1


def test_export_pth_and_predict_round_trip(golden_tree, tmp_path, capsys):
    again = str(tmp_path / "again.pth")
    cli.main(["export-pth", "--weights", golden_tree["pth"], "--model", GOLDEN, "--out", again, *CPU])
    assert _last_json(capsys.readouterr().out)["keys"] == len(load_pth(again))
    a, b = load_pth(again), load_pth(golden_tree["pth"])
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    counts = {}
    for name, main in (("jax", JCLI.main), ("port", cli.main)):
        out = str(tmp_path / f"{name}.png")
        argv = ["predict", "--weights", again, "--model", GOLDEN, "--input-size", "96",
                "--image", golden_tree["image"], "--out", out]
        main(argv + (CPU if name == "port" else []))
        text = capsys.readouterr().out
        counts[name] = int(text.split(" faces")[0].split()[-1])
        assert os.path.getsize(out) > 0
    assert counts["port"] == counts["jax"] > 0
    drawn, src = decode_bgr(str(tmp_path / "port.png")), decode_bgr(golden_tree["image"])
    assert drawn.shape == src.shape and not np.array_equal(drawn, src)
    # Without --weights: a seeded random init, the same twice.
    for i in range(2):
        cli.main(["export-pth", "--model", GOLDEN, "--out", str(tmp_path / f"r{i}.pth"), *CPU])
    assert "[warn] no --weights" in capsys.readouterr().err
    r0, r1 = load_pth(str(tmp_path / "r0.pth")), load_pth(str(tmp_path / "r1.pth"))
    assert all(np.array_equal(r0[k], r1[k]) for k in r0)


def test_dir_predict_export_and_count(golden_tree, tmp_path, capsys):
    src = os.path.join(golden_tree["val"], "0--Golden")
    base = ["--weights", golden_tree["pth"], "--model", GOLDEN, "--input-size", "96", *CPU]
    cli.main(["dir-predict", "--input-dir", src, "--out", str(tmp_path / "o"), "--batch-size", "2", *base])
    lines = capsys.readouterr().out.split("\n")
    assert sorted(os.listdir(tmp_path / "o")) == ["img_0.jpg", "img_1.jpg", "img_2.jpg"]
    assert [ln.split()[0] for ln in lines if ln] == ["img_0.jpg", "img_1.jpg", "img_2.jpg"]
    art = str(tmp_path / "art")
    cli.main(["export", "--out", art, "--batch-size", "2", "--platforms", "cpu", *base])
    assert _last_json(capsys.readouterr().out)["bytes"]["graph.pt2"] > 0
    counts = []
    for argv in (["--exported", art, *CPU], base):
        cli.main(["predict", "--image", golden_tree["image"], "--out", str(tmp_path / "p.png"), *argv])
        counts.append(int(capsys.readouterr().out.split(" faces")[0].split()[-1]))
    assert counts[0] == counts[1] > 0
    cli.main(["count", "--model", GOLDEN, "--size", "96", "--per-layer", *CPU])
    out = _last_json(capsys.readouterr().out)
    assert out["params"] == 426_608 and out["per_layer"][-1]["flops"] == sum(
        r["flops"] for r in out["per_layer"][:-1])


def test_video_on_a_three_frame_clip(golden_tree, tmp_path, capsys):
    clip, out = str(tmp_path / "clip.avi"), str(tmp_path / "out.avi")
    frame = cv2.imread(golden_tree["image"])
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25, (frame.shape[1], frame.shape[0]))
    for i in range(3):
        writer.write(np.roll(frame, 4 * i, axis=1))
    writer.release()
    cli.main(["video", "--video", clip, "--out", out, "--weights", golden_tree["pth"], "--model", GOLDEN,
              "--input-size", "96", *CPU])
    assert "processed 3 frames" in capsys.readouterr().out
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


@pytest.mark.parametrize(
    "argv,slice_name",
    [
        (["recognition", "train", "--data-root", "."], "recognition training slice"),
        (["recognition", "extract", "--image-list", "x", "--out-dir", "o", "--data-parallel"], "parallelism slice"),
        (["predict", "--image", "x.png", "--spatial"], "parallelism slice"),
        (["dir-predict", "--input-dir", ".", "--out", "o", "--data-parallel"], "parallelism slice"),
        (["map-txt", "--val-dir", ".", "--out", "o", "--data-parallel"], "parallelism slice"),
        (["serve", "--data-parallel"], "parallelism slice"),
    ],
)
def test_later_slices_exit_naming_them(argv, slice_name):
    main = cli.main
    if argv[0] == "recognition":
        from jabd_tpu_torch.recognition import cli as rcli

        main, argv = rcli.main, argv[1:]
    with pytest.raises(SystemExit, match=slice_name):
        main(argv + CPU)


def test_serve_int8_and_fps_on_the_cpu_refuse(golden_tree):
    with pytest.raises(SystemExit, match="export an int8 artifact"):
        cli.main(["serve", "--quantize", "int8", *CPU])
    with pytest.raises(RuntimeError, match="CUDA events"):
        cli.main(["fps", "--image", golden_tree["image"], "--weights", golden_tree["pth"], "--model", GOLDEN,
                  "--input-size", "96", "--iters", "1", *CPU])
