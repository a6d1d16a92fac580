"""PyTorch port, spatial partitioning (parallel/spatial.py and
`Predictor(partition="spatial")`) on the CPU: each image's height split
into row blocks over a mesh of repeated `cpu` entries, in float32.

Each case holds the spatial Predictor against the JAX package's
single-device Predictor (XLA NMS; its own spatial file,
tests/test_spatial_predict.py, is slow and holds JAX's GSPMD path to that
same Predictor) and against the port's own single-device Predictor, with
the data-mode tolerances of tests/test_torch_port_parallel_serve.py: keep
masks equal, rows within 1e-4 of JAX and 1e-5 of one device:

- `retinaface_mnet025` at batch 3 over 8 blocks (a batch data mode
  refuses);
- `jabd_flagship` at batch 2, 64x64 over 8 blocks (deep levels gather)
  and 128x128 over 2 (every level stays sharded): stdv-ECA taps, the NLM,
  the bicubic resize, the shared eca_fpn;
- one preset of each other backbone family (one block per stage,
  tests/test_torch_port_resnet.py's `shallow`) at 96x96 over 8 blocks,
  12 rows a block, which stops splitting at stride 8;
- the forward is really partitioned: the stem conv's blocks read only
  their rows and the halo, and an op without a rule raises;
- over a mesh of two distinct devices ([cpu, meta]) every op takes its
  operands from one device and no weight moves during a forward;
- int8, `detect_images`, `detect_multiscale`, the height ValueError and
  `partition`'s validation;
- the CLI's `--spatial` (predict, video, serve, map-txt; identify in
  tests/test_torch_port_pipeline.py) against `--device cpu` and
  `jabd_tpu.cli`, and the int8 clip search of `map-txt` over each mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from jabd_tpu import cli as JCLI
from jabd_tpu import configs as JC
from jabd_tpu import predict as JP
from jabd_tpu_torch import cli
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import predict as TP
from jabd_tpu_torch.eval.run_wider import decode_bgr
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.parallel import spatial as S
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_cli import GOLDEN, _dumps, golden_tree  # noqa: F401
from tests.test_torch_port_model import flagship_variables
from tests.test_torch_port_resnet import shallow


@pytest.fixture(scope="module", autouse=True)
def shallow_backbones():
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        yield


def _pcfgs(size):
    kw = dict(confidence=0.02, input_shape=(size, size))
    return JC.PredictConfig(**kw), TC.PredictConfig(**kw)


def _predictors(name, size, blocks, seed=1):
    """(JAX single-device Predictor, the port's single-device one, the
    port's spatial one over `blocks` cpu entries, the port's state dict),
    the same seeded variables in float32."""
    jcfg = dataclasses.replace(JC.get_model_config(name), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config(name), compute_dtype="float32")
    _, variables = flagship_variables(jcfg, (size, size), seed)
    jp_cfg, tp_cfg = _pcfgs(size)
    state = state_dict_from_flax(variables)
    one = TP.Predictor(tcfg, state, tp_cfg, device="cpu")
    spatial = TP.Predictor(tcfg, state, tp_cfg, mesh=M.make_mesh(["cpu"] * blocks), partition="spatial")
    return JP.Predictor(jcfg, variables, jp_cfg, use_pallas=False), one, spatial, state


@pytest.fixture(scope="module")
def mnet():
    return _predictors("retinaface_mnet025", 64, 8)


def _hold(spatial, one, jpred, x, tol_one=1e-5, tol_jax=1e-4):
    """Keep masks equal to one device and to JAX; rows within the stated
    bounds. Returns the max row errors (one device, JAX)."""
    d, v = (t.numpy() for t in spatial.detect_preprocessed(x))
    d1, v1 = (t.numpy() for t in one.detect_preprocessed(x))
    jd, jv = (np.asarray(t) for t in jpred.detect_preprocessed(x))
    assert int(v.sum()) > 0  # a non-vacuous comparison
    np.testing.assert_array_equal(v, v1)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(d[v], d1[v], atol=tol_one, rtol=0)
    np.testing.assert_allclose(d[v], jd[v], atol=tol_jax, rtol=0)
    return float(np.abs(d - d1)[v].max()), float(np.abs(d - jd)[v].max())


def test_mnet025_batch_3_over_8_blocks(mnet):
    """Batch 3 does not divide the mesh, which data mode refuses: the
    spatial mode has no batch constraint. Observed max row error 0 to one
    device, 1.2e-7 to JAX."""
    jpred, one, spatial, _ = mnet
    x = np.random.default_rng(2).normal(0, 50, (3, 64, 64, 3)).astype(np.float32)
    _hold(spatial, one, jpred, x)
    assert spatial.mesh.size == 8 and spatial.replicas == [spatial.model]


@pytest.mark.parametrize("size,blocks", [(64, 8), (128, 2)])
def test_flagship_over_the_mesh(size, blocks):
    """64 over 8 (1 row a block at stride 8: the deeper levels gather) and
    128 over 2 (every level stays sharded): stdv-ECA taps (two-pass over
    the blocks), the NLM over gathered keys, the bicubic resize, the shared
    eca_fpn. Observed max row error 1.0e-6 / 7.2e-7 to one device, 1.2e-6
    / 7.8e-7 to JAX."""
    jpred, one, spatial, _ = _predictors("jabd_flagship", size, blocks)
    heads = {}
    for name, m in spatial.model.named_modules():
        if name.startswith("bbox_head"):
            m.register_forward_pre_hook(lambda m, a, name=name: heads.update({name: type(a[0]).__name__}))
    x = np.random.default_rng(4).normal(0, 50, (2, size, size, 3)).astype(np.float32)
    _hold(spatial, one, jpred, x)
    sharded = [heads[f"bbox_head{i}"] == "ShardedRows" for i in (1, 2, 3)]
    assert sharded == ([True, True, True] if blocks == 2 else [True, False, False])


@pytest.mark.parametrize("size,blocks", [(64, 8), (128, 2)])
def test_flagship_in_float64_equals_one_device(size, blocks):
    """The same graph in float64 gives one device's heads: the blocks
    compute the single device's function, and their float32 differences
    are rounding. At this seed the two float32 paths round apart (heads
    observed 5.4e-4 apart at 64x64, 3.3e-4 at 128x128); in float64 they
    agree (observed 0)."""
    _, one, spatial, _ = _predictors("jabd_flagship", size, blocks, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 50, (2, size, size, 3))).permute(0, 3, 1, 2)
    errs = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.float64):
            want = one.model.to(dtype)(x.to(dtype))
            got = spatial.model.to(dtype)(S.shard_rows(x.to(dtype), spatial.mesh.devices))
            errs.append(max(float((g - w).abs().max()) for g, w in zip(got, want)))
    assert errs[1] <= 1e-12 < errs[0]


@pytest.mark.parametrize("preset", ["re50_eca_nonlocal", "epsa50_4level", "jabd_pixelshuffle"])
def test_backbone_families_at_a_misaligned_height(preset):
    """96 over 8 blocks: 12 rows a block, 3 at stride 8, so the next
    stride-2 op finds blocks that do not start on its stride and the level
    gathers. re50: the 7x7 s2 stem and the -inf-padded max pool; epsa50:
    the grouped 3/5/7/9 convs of PSA (mixed sharded and gathered splits)
    and the 4-level wiring; pixelshuffle: PixelShuffleUp and its crop.
    Observed max row error 0 / 1.3e-6 / 2.4e-7 to one device, 2.3e-5 /
    2.0e-6 / 2.4e-7 to JAX."""
    jpred, one, spatial, _ = _predictors(preset, 96, 8, seed=5)
    x = np.random.default_rng(6).normal(0, 50, (2, 96, 96, 3)).astype(np.float32)
    _hold(spatial, one, jpred, x)


def test_pixelshuffle_fpn_stays_sharded():
    """jabd_pixelshuffle at 128 over 2 blocks: every level stays sharded,
    so PixelShuffleUp's conv, depth-to-space and crop run on row blocks.
    Observed max row error 2.4e-7 to one device, 2.7e-7 to JAX."""
    jpred, one, spatial, _ = _predictors("jabd_pixelshuffle", 128, 2, seed=5)
    seen = []
    spatial.model.fpn.pix.register_forward_hook(lambda m, a, out: seen.append(type(out).__name__))
    x = np.random.default_rng(6).normal(0, 50, (2, 128, 128, 3)).astype(np.float32)
    _hold(spatial, one, jpred, x)
    assert seen and set(seen) == {"ShardedRows"}


_W = torch.from_numpy(np.random.default_rng(12).normal(0, 0.3, (4, 2, 3, 3)).astype(np.float32))
_W11 = torch.from_numpy(np.random.default_rng(13).normal(0, 0.1, (4, 4, 11, 11)).astype(np.float32))
RULE_CASES = {
    "pointwise": (lambda t: torch.sigmoid(t) * 2.0 + t ** 2 / 3.0 - 1.0, True),
    "softmax over channels": (lambda t: torch.softmax(t, dim=1), True),
    "sum over the rows": (lambda t: t.sum(dim=(2, 3), keepdim=True), False),
    "mean over channels": (lambda t: t.mean(dim=1), True),
    "pixel shuffle and crop": (lambda t: F.pixel_shuffle(t, 2)[:, :, :31], True),
    "stack, unbind, cat, index": (lambda t: torch.cat(torch.stack([t, t + 1], dim=1).unbind(1)[::-1], dim=1)[:, 1],
                                  True),
    "max pool, -inf edges": (lambda t: F.max_pool2d(t - 5.0, 3, 2, 1), True),
    "strided dilated grouped conv": (lambda t: F.conv2d(t, _W, None, 2, 2, 2, 2), True),
    "a halo past the neighbours gathers": (lambda t: F.conv2d(t, _W11, None, 1, 5), False),
    "a full map cut to the blocks": (lambda t: t + S.gather_rows(t), True),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_op_rules_give_the_plain_op(case):
    """Each kind of op rule over 4 blocks of 4 rows against the plain op on
    the whole tensor; `sharded` says whether the result stays in blocks."""
    fn, sharded = RULE_CASES[case]
    x = torch.from_numpy(np.random.default_rng(14).normal(0, 1, (2, 4, 16, 8)).astype(np.float32))
    got = fn(S.shard_rows(x, ["cpu"] * 4))
    assert isinstance(got, S.ShardedRows) == sharded
    torch.testing.assert_close(S.gather_rows(got), fn(x), rtol=1e-6, atol=1e-6)


def test_the_forward_is_really_partitioned(mnet, monkeypatch):
    """In place of JAX's "the compiled module holds collectives": a hook
    on the first conv (3x3, stride 2, padding 1) sees block i hold rows
    [8i, 8i + 8) of the 64, and the conv's windows (recorded inside
    `stencil`) are exactly the rows [8i - 1, 8i + 8), clipped at the image
    and zero-padded past it, for its output rows [4i, 4i + 4); and an op
    without a rule raises instead of gathering."""
    _, one, spatial, _ = mnet
    seen, windows = {}, []
    stencil = S.stencil

    def recording(x, k, s, p, d, value, fn):
        mine = []
        windows.append(mine)
        return stencil(x, k, s, p, d, value, lambda t, top: (mine.append(t), fn(t, top))[1])

    monkeypatch.setattr(S, "stencil", recording)
    hook = spatial.model.backbone.stem.conv.register_forward_hook(
        lambda m, a, out: seen.update(x=a[0], out=out))
    x = np.random.default_rng(8).normal(0, 50, (1, 64, 64, 3)).astype(np.float32)
    try:
        spatial.detect_preprocessed(x)
    finally:
        hook.remove()
    inp, out = seen["x"], seen["out"]
    assert isinstance(inp, S.ShardedRows) and isinstance(out, S.ShardedRows)
    assert inp.bounds == tuple(range(0, 65, 8)) and [p.shape[2] for p in inp.parts] == [8] * 8
    whole = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = [F.pad(whole[:, :, max(8 * i - 1, 0):8 * i + 8], (0, 0, int(i == 0), 0)) for i in range(8)]
    assert len(windows[0]) == 8 and all(torch.equal(w, v) for w, v in zip(windows[0], want))
    assert out.bounds == tuple(range(0, 33, 4))
    with torch.no_grad():
        want = one.model.backbone.stem.conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(S.gather_rows(out), want, atol=1e-5, rtol=0)
    t = S.shard_rows(torch.zeros(1, 4, 16, 8), ["cpu", "cpu"])
    for op in (lambda: torch.flip(t, [2]), lambda: F.adaptive_avg_pool2d(t, 3), lambda: t.flatten(2),
               lambda: torch.cat([t, t], dim=2)):
        with pytest.raises(NotImplementedError, match="spatial partitioning"):
            op()


class OneDevicePerOp(TorchDispatchMode):
    """Records every op whose tensor operands lie on more than one device
    (a 0-dim CPU scalar aside, as CUDA allows) and every copy of one of
    `weights` to another device. A copy out of a meta tensor gives zeros,
    so a forward can run with blocks on `meta`, a device distinct from the
    CPU, as a second card is from the first."""

    def __init__(self, weights):
        super().__init__()
        self.weights, self.mixed, self.weight_copies = weights, [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in (torch.ops.aten.to, torch.ops.aten._to_copy):
            src = args[0]
            dev = kwargs.get("device") or next((a for a in args[1:] if isinstance(a, torch.device)), src.device)
            if dev != src.device and any(src is w for w in self.weights):
                self.weight_copies += 1
            if src.device.type == "meta" and dev.type != "meta":
                dtype = kwargs.get("dtype") or next((a for a in args[1:] if isinstance(a, torch.dtype)), src.dtype)
                return torch.zeros(src.shape, dtype=dtype, device=dev)
        else:
            devices = {t.device for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor) and not (t.dim() == 0 and t.device.type == "cpu")}
            if len(devices) > 1:
                self.mixed.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("name,size,int8", [("retinaface_mnet025", 64, False), ("retinaface_mnet025", 64, True),
                                            ("jabd_flagship", 128, False), ("re50_eca_nonlocal", 96, False)])
def test_blocks_compute_on_their_own_device(name, size, int8):
    """A mesh of two distinct devices, [cpu, meta]: every op of the spatial
    forward (convs, the NLM's attention, the int8 convs, the stem's max
    pool) takes its operands from one device, and no weight moves during
    the forward (partition_model copied them once). A block that computed
    with the first device's weights (the NLM's queries, an int8 window)
    or a conv that copied its weights per call fails here."""
    cfg = dataclasses.replace(TC.get_model_config(name), compute_dtype="float32")
    torch.manual_seed(0)
    state = build_model(cfg, mode="eval", device="cpu").state_dict()
    pred = TP.Predictor(cfg, state, TC.PredictConfig(confidence=0.02, input_shape=(size, size)),
                        mesh=M.make_mesh(["cpu", "meta"]), partition="spatial")
    rng = np.random.default_rng(15)
    if int8:
        assert pred.quantize_int8(rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)) > 0
    weights = list(pred.model.parameters()) + list(pred.model.buffers())
    with OneDevicePerOp(weights) as mode:
        dets, valid = pred.detect_preprocessed(rng.normal(0, 50, (1, size, size, 3)).astype(np.float32))
    assert dets.device.type == "cpu" and dets.shape[0] == 1
    assert mode.mixed == [] and mode.weight_copies == 0


def test_stdv_is_two_pass_over_the_blocks():
    """The stdv-ECA statistic over 4 blocks of a map whose mean (300) is
    large against its spread (1): the global mean first, then the squared
    deviations from it. E[x^2] - E[x]^2 in float32 lies more than 1e-3
    from float64 here (observed 7.3e-3: cancellation at 9e4)."""
    from jabd_tpu_torch.models.layers import _spatial_stdv

    x = 300 + torch.from_numpy(np.random.default_rng(9).normal(0, 1, (2, 3, 16, 8)).astype(np.float32))
    got = _spatial_stdv(S.shard_rows(x, ["cpu"] * 4))
    assert not isinstance(got, S.ShardedRows) and got.shape == (2, 3)
    # observed max relative error 4.9e-8 to float64, as one device's
    torch.testing.assert_close(got.double(), _spatial_stdv(x.double()), rtol=1e-5, atol=0)
    torch.testing.assert_close(_spatial_stdv(x).double(), _spatial_stdv(x.double()), rtol=1e-5, atol=0)
    one_pass = torch.sqrt((x ** 2).mean(dim=(2, 3)) - x.mean(dim=(2, 3)) ** 2)
    assert float(((one_pass.double() - _spatial_stdv(x.double())) / _spatial_stdv(x.double())).abs().max()) > 1e-3


def test_int8_equals_int8_on_one_device(mnet):
    """quantize_int8 on the spatial Predictor (int8 convs on each block's
    window, padded with the quantized zero) equals quantize_int8 on one
    device, bit for bit."""
    _, one, spatial, state = mnet
    rng = np.random.default_rng(10)
    calib = rng.integers(0, 256, (2, 80, 72, 3), dtype=np.uint8)
    q_one = TP.Predictor(one.mcfg, state, one.pcfg, device="cpu")
    q_sp = TP.Predictor(one.mcfg, state, one.pcfg, mesh=spatial.mesh, partition="spatial")
    assert q_one.quantize_int8(calib) == q_sp.quantize_int8(calib) > 0
    assert any(type(m) is S.SpatialQConv for m in q_sp.model.modules())
    x = rng.normal(0, 50, (3, 64, 64, 3)).astype(np.float32)
    (d0, v0), (d1, v1) = q_one.detect_preprocessed(x), q_sp.detect_preprocessed(x)
    assert int(v0.sum()) > 0 and torch.equal(v0, v1) and torch.equal(d0, d1)


def test_detect_images_and_multiscale_equal_one_device(mnet):
    """Mixed sizes letterboxed on the first device, then sharded; the
    pyramid's three scales through the spatial detect_image. Observed 0 px
    to one device."""
    _, one, spatial, _ = mnet
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((70, 90), (64, 64), (120, 50))]
    got, want = spatial.detect_images(images), one.detect_images(images)
    assert [len(g) for g in got] == [len(w) for w in want] and sum(map(len, got)) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    g, w = spatial.detect_multiscale(images[0]), one.detect_multiscale(images[0])
    assert len(g) == len(w) > 0
    np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_height_and_partition_are_validated(mnet):
    """JAX's ValueError for a height the mesh does not divide (68 over 8),
    checked before the forward; `partition` takes 'data' or 'spatial'."""
    _, one, spatial, state = mnet
    with pytest.raises(ValueError, match="input height 68 must divide the serving mesh size 8"):
        spatial.detect_preprocessed(np.zeros((1, 68, 68, 3), np.float32))
    with pytest.raises(ValueError, match="partition"):
        TP.Predictor(one.mcfg, state, one.pcfg, device="cpu", partition="pipeline")


@pytest.mark.parametrize("mesh", [None, "data", "spatial"])
def test_map_txt_clip_search_scores_the_quantized_model(mnet, golden_tree, monkeypatch, mesh):  # noqa: F811
    """`map-txt --quantize int8 --quantize-search --gt-dir` scores each clip
    ratio by a sweep of that ratio's int8 model: the model the Predictor
    serves with (its replicas, its spatial rules) must be the candidate, on
    one device and over either mesh."""
    import argparse

    from jabd_tpu_torch.eval import run_wider as RW
    from jabd_tpu_torch.models import quantize as Q

    _, one, _, state = mnet
    kw = dict(device="cpu") if mesh is None else dict(mesh=M.make_mesh(["cpu", "cpu"]), partition=mesh)
    pred = TP.Predictor(one.mcfg, state, one.pcfg, **kw)
    served = []

    def sweep(p, val_dir, batch_size):
        served.append({type(m) for r in p.replicas for m in r.modules()})
        return {}

    monkeypatch.setattr(RW, "run_wider_val", sweep)
    monkeypatch.setattr("jabd_tpu_torch.eval.evaluate_wider", lambda preds, gt: dict(easy=0, medium=0, hard=0))
    args = argparse.Namespace(val_dir=golden_tree["val"], quantize_search=True, gt_dir="gt", batch_size=2)
    cli._quantize_for_map_txt(args, pred)
    want = S.SpatialQConv if mesh == "spatial" else Q.QConv
    assert len(served) == 7 and all(want in types for types in served)
    assert all(want in {type(m) for m in r.modules()} for r in pred.replicas)


@pytest.fixture
def float32_presets(monkeypatch):
    for mod in (JC, TC):
        get = mod.get_model_config
        monkeypatch.setattr(mod, "get_model_config",
                            lambda name, get=get: dataclasses.replace(get(name), compute_dtype="float32"))


def test_cli_predict_spatial(golden_tree, tmp_path, capsys, float32_presets):  # noqa: F811
    """`predict --spatial --device cpu,cpu` draws what `--device cpu`
    draws and counts the faces `jabd_tpu.cli predict` counts."""
    common = ["predict", "--image", golden_tree["image"], "--weights", golden_tree["pth"], "--model", GOLDEN,
              "--input-size", "96"]
    counts, outs = [], []
    for i, (main, extra) in enumerate(((cli.main, ["--spatial", "--device", "cpu,cpu"]),
                                       (cli.main, ["--device", "cpu"]), (JCLI.main, []))):
        outs.append(str(tmp_path / f"{i}.png"))
        main(common + ["--out", outs[-1]] + extra)
        captured = capsys.readouterr()
        counts.append(int(captured.out.split(" faces")[0].split()[-1]))
        if i == 0:
            assert "[mesh] forward spatially partitioned over 2 devices" in captured.err
    assert counts[0] == counts[1] == counts[2] > 0
    assert np.array_equal(decode_bgr(outs[0]), decode_bgr(outs[1]))


def test_cli_video_spatial(golden_tree, tmp_path, capsys, float32_presets):  # noqa: F811
    """`video --spatial` over [cpu, cpu] runs a 3-frame MJPG clip through
    the spatial detect_image and writes every frame."""
    import cv2

    clip, out = str(tmp_path / "clip.avi"), str(tmp_path / "out.avi")
    frame = cv2.imread(golden_tree["image"])
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25, (frame.shape[1], frame.shape[0]))
    for i in range(3):
        writer.write(np.roll(frame, 4 * i, axis=1))
    writer.release()
    cli.main(["video", "--video", clip, "--out", out, "--weights", golden_tree["pth"], "--model", GOLDEN,
              "--input-size", "96", "--spatial", "--device", "cpu,cpu"])
    assert "processed 3 frames" in capsys.readouterr().out
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


def test_cli_serve_and_map_txt_spatial(golden_tree, tmp_path, monkeypatch, capsys, float32_presets):  # noqa: F811
    """`serve --spatial --batch-size 1` over [cpu, cpu] hands serve() a
    BatchingDetector that answers what one device answers; `map-txt
    --spatial --batch-size 3` (a chunk the mesh does not divide) writes
    the single-device dumps; `export --spatial` refuses, as JAX's does."""
    from jabd_tpu_torch import serve as SV

    common = ["--model", GOLDEN, "--weights", golden_tree["pth"], "--input-size", "96"]
    seen = []
    monkeypatch.setattr(SV, "serve", lambda det, **kw: seen.append(det))
    cli.main(["serve", *common, "--batch-size", "1", "--spatial", "--device", "cpu,cpu"])
    det = seen[0]
    try:
        assert det.backend.partition == "spatial" and det.backend.mesh.size == 2 and det.batch_size == 1
        ref = cli._load_predictor(cli.build_parser().parse_args(["predict", "--image", "x", *common,
                                                                 "--device", "cpu"]))
        img = decode_bgr(golden_tree["image"])
        want = ref.detect_image(img)
        got = det.detect(img)
        assert len(want) > 0
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)  # observed 1.5e-5 px
    finally:
        det.close()
    for tag, extra in (("sp", ["--spatial", "--device", "cpu,cpu"]), ("one", ["--device", "cpu"])):
        cli.main(["map-txt", *common, "--val-dir", golden_tree["val"], "--out", str(tmp_path / tag),
                  "--batch-size", "3", *extra])
    sp, one = _dumps(tmp_path / "sp"), _dumps(tmp_path / "one")
    assert sp.keys() == one.keys() and len(sp) == 3
    for k in one:
        assert sp[k][:2] == one[k][:2]
        np.testing.assert_allclose(sp[k][2], one[k][2], atol=1e-3, rtol=0)
    capsys.readouterr()
    with pytest.raises(ValueError, match="single-device"):
        cli.main(["export", *common, "--out", str(tmp_path / "art"), "--platforms", "cpu", "--spatial",
                  "--device", "cpu,cpu"])
    with pytest.raises(SystemExit, match="--spatial runs the live model"):
        cli.main(["predict", "--image", golden_tree["image"], "--exported", str(tmp_path / "art"), "--spatial",
                  "--device", "cpu,cpu"])
