"""PyTorch port, the presets slice's modules against their flax twins at
float32 on the CPU: ResNet's Bottleneck and backbone, EPSANet's
PSAModule (reversed concatenation, one SE shared by the splits) and
EPSABlock, PixelShuffleUp and the pixel-shuffle FPN at odd grids, the
4-level FPN wirings raw152 / raw152_5, the 4-stage MobileNetV3 split,
`iou_pairwise_general`, and the eval heads of each of the 14 presets
this slice adds.

Backbone depth is cut to one block per stage here: both packages read
`RESNET_SPECS` (and the port `EPSANET50_SPEC`, the JAX package the
`EPSANetBackbone` class) when a model is built, so the test swaps them
for the module's duration; widths stay the published ones. Weights are
numpy-seeded values on `jax.eval_shape` shapes (test_torch_port_model.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jabd_tpu.models.epsa as JE
import jabd_tpu.models.mobilenet as JM
import jabd_tpu.models.resnet as JRN
import jabd_tpu_torch.models.epsa as TE
import jabd_tpu_torch.models.mobilenet as TM
import jabd_tpu_torch.models.resnet as TRN
from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.models import layers as JL
from jabd_tpu.ops import boxes as JB
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models import layers as TL
from jabd_tpu_torch.ops import boxes as TB
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.conftest import random_boxes
from tests.test_torch_port_model import _module_pair, seeded_variables, to_nchw, to_nhwc

# The 14 presets the presets slice adds.
NEW_PRESETS = (
    "jabd_pixelshuffle", "mnet_v3_4level", "re50_eca_nonlocal", "re50_dropout",
    "re50_baseline", "re50_self_4level", "re152_4level", "re50_fpn_att",
    "re50_backbone_att", "re50_contrast_eca", "re50_nonlocal", "re50_eca_hsigmoid",
    "re50_iou_head", "epsa50_4level",
)


def shallow(monkeypatch):
    """One block per stage in every ResNet spec and in EPSANet-50, in both
    packages, until `monkeypatch` undoes it."""
    for specs in (JRN.RESNET_SPECS, TRN.RESNET_SPECS):
        for name, (blocks, planes, taps) in list(specs.items()):
            monkeypatch.setitem(specs, name, ([1] * len(blocks), planes, taps))
    blocks, planes, taps = TE.EPSANET50_SPEC
    monkeypatch.setattr(TE, "EPSANET50_SPEC", ([1] * len(blocks), planes, taps))

    class ShallowEPSANet(JE.EPSANetBackbone):
        blocks: tuple = (1, 1, 1, 1, 1)

    monkeypatch.setattr(JE, "EPSANetBackbone", ShallowEPSANet)


@pytest.fixture(scope="module", autouse=True)
def shallow_backbones():
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        yield


# Both packages' full-depth tables, read before the module cuts them.
FULL_SPECS = (dict(TRN.RESNET_SPECS), dict(JRN.RESNET_SPECS))
FULL_EPSA = (TE.EPSANET50_SPEC, (JE.EPSANetBackbone.blocks, JE.EPSANetBackbone.planes, JE.EPSANetBackbone.taps))


def test_tables_match_the_jax_package():
    """The seven ResNet specs and EPSANet-50's at full depth, and the
    4-stage MobileNetV3 split."""
    port, jax_specs = FULL_SPECS
    assert port == jax_specs and len(port) == 7
    assert port["resnet50_self"][0] == [3, 4, 2, 4, 3]
    blocks, planes, taps = FULL_EPSA[0]
    assert (tuple(blocks), tuple(planes), taps) == tuple(tuple(v) for v in FULL_EPSA[1])
    assert TM.MNV3_LARGE_4STAGE == [list(s) for s in JM.MNV3_LARGE_4STAGE]


@pytest.mark.parametrize(
    "cin,planes,stride,down",
    [(64, 64, 1, True), (256, 64, 1, False), (256, 128, 2, True), (512, 256, 2, True)],
)
def test_bottleneck(rng, cin, planes, stride, down):
    x = rng.normal(0, 1, (2, 9, 11, cin)).astype(np.float32)
    want, got = _module_pair(
        JRN.Bottleneck(planes=planes, stride=stride, downsample=down),
        TRN.Bottleneck(cin, planes, stride, down), x, train=False,
    )
    assert got.shape[1:] == (planes * 4, -(-9 // stride), -(-11 // stride))
    # observed max error 4.5e-6 on values up to 6.2; stated tolerance 1e-5 * max(1, max|ref|)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("name", ["resnet50", "resnet152_l4", "resnet50_self"])
def test_resnet_backbone_taps(rng, name):
    """Stem, the -inf-padded max pool and the stages; one block each."""
    blocks, planes, taps = TRN.RESNET_SPECS[name]
    x = rng.normal(0, 50, (2, 67, 53, 3)).astype(np.float32)
    jmod = JRN.ResNetBackbone(blocks=tuple(blocks), planes=tuple(planes), taps=taps)
    tmod = TRN.build_resnet(name)
    shapes = jax.eval_shape(functools.partial(jmod.init, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    v = seeded_variables(shapes, 4)
    want = jax.jit(functools.partial(jmod.apply, train=False))(v, jnp.asarray(x))
    tmod.load_state_dict(state_dict_from_flax(v))
    tmod.eval()
    with torch.no_grad():
        got = tmod(to_nchw(x))
    assert len(got) == len(want) == len(taps)
    for w, g in zip(want, got):
        w = np.asarray(w)
        # observed max error 2.7e-4 on values up to 3.9e2; stated 1e-5 * max(1, max|ref|)
        np.testing.assert_allclose(to_nhwc(g), w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("planes,stride", [(64, 1), (128, 2)])
def test_psa_module(rng, planes, stride):
    """The four grouped convs, the SE shared by the splits and the softmax
    across them, concatenated split 4 first."""
    x = rng.normal(0, 1, (2, 9, 8, planes)).astype(np.float32)
    jmod = JE.PSAModule(planes, stride=stride)
    tmod = TE.PSAModule(planes, planes, stride)
    want, got = _module_pair(jmod, tmod, x, train=False)
    want = np.asarray(want)
    assert [n for n, _ in tmod.named_children()].count("se") == 1
    # observed max error 7.2e-7; stated tolerance 1e-5
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-5, rtol=0)
    # Natural split order gives the same shape and other numbers.
    q = planes // 4
    natural = np.concatenate([want[..., (3 - i) * q : (4 - i) * q] for i in range(4)], -1)
    assert np.abs(natural - want).max() > 1e-2


@pytest.mark.parametrize("cin,planes,stride,down", [(64, 64, 1, True), (1024, 256, 1, False), (256, 128, 2, True)])
def test_epsa_block(rng, cin, planes, stride, down):
    """conv1, PSA, the bare bn2 (seeded statistics), conv3 and the skip."""
    x = rng.normal(0, 1, (2, 10, 7, cin)).astype(np.float32)
    want, got = _module_pair(
        JE.EPSABlock(planes, stride=stride, downsample=down),
        TE.EPSABlock(cin, planes, stride, down), x, train=False,
    )
    # observed max error 9.5e-7 on values up to 5.2; stated tolerance 1e-5 * max(1, max|ref|)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("hw", [(7, 5), (1, 1), (4, 6)])
def test_pixel_shuffle_up(rng, hw):
    x = rng.normal(0, 1, (2, *hw, 16)).astype(np.float32)
    want, got = _module_pair(JL.PixelShuffleUp(16), TL.PixelShuffleUp(16), x)
    assert got.shape == (2, 16, 2 * hw[0], 2 * hw[1])
    # observed max error 0.0; stated tolerance 1e-5
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def _fpn_pair(rng, jfpn, tfpn, sizes, channels, seed):
    taps = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in zip(sizes, channels)]
    jt = [jnp.asarray(t) for t in taps]
    shapes = jax.eval_shape(functools.partial(jfpn.init, train=False), jax.random.PRNGKey(0), jt)
    v = seeded_variables(shapes, seed)
    want = jax.jit(functools.partial(jfpn.apply, train=False))(v, jt)
    tfpn.load_state_dict(state_dict_from_flax(v))  # strict: the variant's parameters only
    tfpn.eval()
    with torch.no_grad():
        got = tfpn([to_nchw(t) for t in taps])
    return [np.asarray(w) for w in want], [to_nhwc(g) for g in got]


@pytest.mark.parametrize("nlm_ch", [None, 8])
def test_fpn_pixelshuffle_at_odd_grids(rng, nlm_ch):
    """27/14/7 (and 13 wide): the shared x2 pixel shuffle cropped to each
    lateral's grid."""
    sizes, channels = ((27, 13), (14, 7), (7, 4)), (8, 12, 16)
    jfpn = JL.FPN(out_channels=16, upsample="pixelshuffle", nlm_ch=nlm_ch)
    tfpn = TL.FPN(channels, 16, upsample="pixelshuffle", nlm_ch=nlm_ch)
    want, got = _fpn_pair(rng, jfpn, tfpn, sizes, channels, seed=5)
    for w, g in zip(want, got):
        # observed max error 2.4e-6; stated tolerance 1e-5
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_fpn_pixelshuffle_refuses_a_grid_it_cannot_reach(rng):
    tfpn = TL.FPN((8, 16), 16, upsample="pixelshuffle").eval()
    with torch.no_grad(), pytest.raises(ValueError, match="cannot reach"):
        tfpn([torch.zeros(1, 8, 9, 9), torch.zeros(1, 16, 4, 4)])


@pytest.mark.parametrize("variant", ["raw152", "raw152_5"])
@pytest.mark.parametrize("upsample,nlm_ch", [("nearest", None), ("bicubic", 8)])
def test_fpn_four_level_wirings(rng, variant, upsample, nlm_ch):
    """One merge_shared conv, the order 2->1, 4->3, 3->2, level 2 from the
    merged (raw152) or the raw (raw152_5) level 3; outputs [o1, o2, o3, l4]."""
    sizes, channels = ((27, 25), (14, 13), (7, 7), (4, 4)), (8, 12, 12, 16)
    jfpn = JL.FPN(out_channels=16, upsample=upsample, nlm_ch=nlm_ch, variant=variant)
    tfpn = TL.FPN(channels, 16, upsample=upsample, nlm_ch=nlm_ch, variant=variant)
    assert not any(n.startswith("merge") and n != "merge_shared" for n, _ in tfpn.named_children())
    want, got = _fpn_pair(rng, jfpn, tfpn, sizes, channels, seed=6)
    for w, g in zip(want, got):
        # observed max error 1.9e-6; stated tolerance 1e-5
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_fpn_variants_differ_in_level_two(rng):
    """raw152 and raw152_5 share shapes and every output but o2."""
    sizes, channels = ((16, 16), (8, 8), (4, 4), (2, 2)), (8, 8, 8, 8)
    taps = [torch.from_numpy(rng.normal(0, 1, (1, c, h, w)).astype(np.float32)) for (h, w), c in zip(sizes, channels)]
    a = TL.FPN(channels, 16, variant="raw152").eval()
    b = TL.FPN(channels, 16, variant="raw152_5").eval()
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        oa, ob = a(taps), b(taps)
    for i, (x, y) in enumerate(zip(oa, ob)):
        assert x.shape == y.shape
        assert torch.equal(x, y) == (i != 1), i


def test_mnv3_four_stage_backbone(rng):
    """The 4-stage split: taps 40/80/80/160 at strides 8/16/16/32."""
    x = rng.normal(0, 50, (2, 64, 48, 3)).astype(np.float32)
    jmod = JM.MobileNetV3Backbone(stages=tuple(tuple(s) for s in JM.MNV3_LARGE_4STAGE), block_attention="eca")
    tmod = TM.MobileNetV3Backbone(TM.MNV3_LARGE_4STAGE, block_attention="eca")
    want, got = _module_pair(jmod, tmod, x, train=False)
    assert [tuple(g.shape[1:]) for g in got] == [(40, 8, 6), (80, 4, 3), (80, 4, 3), (160, 2, 2)]
    for w, g in zip(want, got):
        # observed max error 6.1e-5 on values up to 1.5e2; stated tolerance 1e-5 * max(1, max|ref|)
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_iou_pairwise_general(rng, kind):
    a, b = random_boxes(rng, 20), random_boxes(rng, 30)
    a[3] = b[5]  # one identical pair
    want = np.asarray(JB.iou_pairwise_general(jnp.asarray(a), jnp.asarray(b), kind))
    got = TB.iou_pairwise_general(torch.from_numpy(a), torch.from_numpy(b), kind).numpy()
    assert got.shape == (20, 30)
    # observed max error 1.2e-7 (ciou; 0.0 for the others); stated tolerance 1e-6
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # As tests/test_boxes.py holds the JAX function.
    assert np.all(got <= 1.0 + 1e-6) and np.all(got >= -2.0)
    np.testing.assert_allclose(got[3, 5], 1.0, atol=1e-5)
    same = TB.iou_pairwise_general(torch.from_numpy(a), torch.from_numpy(a), kind).numpy().diagonal()
    np.testing.assert_allclose(same, 1.0, atol=1e-5)
    if kind == "diou":
        elem = TB.elementwise_diou(torch.from_numpy(a), torch.from_numpy(b[:20])).numpy()
        np.testing.assert_allclose(elem, got[np.arange(20), np.arange(20)], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown iou kind"):
        TB.iou_pairwise_general(torch.from_numpy(a), torch.from_numpy(b), "xiou")


def preset_pair(name, hw, seed=0):
    """(JAX eval model, seeded variables, port eval model with them) for
    `name` at float32, at this module's depth."""
    jcfg = dataclasses.replace(JC.get_model_config(name), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config(name), compute_dtype="float32")
    jmodel = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32)
    )
    variables = seeded_variables(shapes, seed)
    tmodel = build_model(tcfg, mode="eval", device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_new_preset_eval_heads_match_jax(name):
    """Every head of the preset at 72x56 (odd pyramid grids: 9x7, 5x4,
    3x2), eval mode, one block per backbone stage."""
    hw = (72, 56)
    jmodel, variables, tmodel = preset_pair(name, hw, seed=3)
    x = np.random.default_rng(11).normal(0, 50, (2, *hw, 3)).astype(np.float32)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(to_nchw(x))
    assert len(got) == len(want) == (4 if name == "re50_iou_head" else 3)
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, i
        # observed max error 1.7e-4 on heads up to 9.1 (re50_nonlocal), 2.0e-6 to
        # 5.5e-5 for the others;
        # stated tolerance 1e-4 * max(1, max|ref|)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=f"{name} {i}")
