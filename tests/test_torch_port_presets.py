"""PyTorch port, the presets slice's training against the JAX package on
the CPU: one train step of a preset of each family, ResNet 3-level
(re50_eca_nonlocal), ResNet 4-level (re152_4level), EPSANet
(epsa50_4level) and MobileNetV3 4-level (mnet_v3_4level), at float32
(loss terms, gradients, BatchNorm statistics; the port's float64 step
arbitrates the gradients); `re50_dropout`'s tap dropout (eval equal to
JAX; train mode with every mask forced to ones equal to JAX; drop share
and scale by statistics; the per-step stream); the IoU head's refusals.

Backbones run one block per stage (tests/test_torch_port_resnet.py's
`shallow`), at the published widths, batch 2.
"""

import dataclasses
import functools

import flax.linen.stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jabd_tpu_torch.models.retinaface as TR
from jabd_tpu import configs as JC
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TLoss
from jabd_tpu_torch import predict as TP
from jabd_tpu_torch import step as ST
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_model import to_nchw
from tests.test_torch_port_resnet import shallow
from tests.test_torch_port_train import _synthetic_batch

SIZE = 64
KW = dict(batch_size=2, image_size=SIZE, max_targets=4)
FAMILIES = ("re50_eca_nonlocal", "re152_4level", "epsa50_4level", "mnet_v3_4level")


@pytest.fixture(scope="module", autouse=True)
def shallow_backbones():
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        yield


def level_batch(seed, size, bsz=2):
    """Noise images and 4 faces an image, 4%, 15%, 45% and 90% of the
    image wide, all but one with landmarks, so that most pyramid levels
    get positives. One slot of the last image is padding."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 50, (bsz, size, size, 3)).astype(np.float32)
    wh = np.array([0.04, 0.15, 0.45, 0.9])[None, :, None] * rng.uniform(0.8, 1.1, (bsz, 4, 2))
    cxy = wh / 2 + rng.uniform(0, 1, (bsz, 4, 2)) * (1 - wh)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    labels = np.ones((bsz, 4), np.float32)
    labels[0, 0] = -1.0  # a face without landmarks
    landms = (np.repeat(cxy, 5, axis=1).reshape(bsz, 4, 10) + rng.normal(0, 0.01, (bsz, 4, 10))).astype(np.float32)
    valid = np.ones((bsz, 4), bool)
    valid[-1, -1] = False
    boxes[-1, -1] = 0.0
    return images, (boxes, labels, landms, valid)


# (image size, batch) per family. MobileNetV3's SE modules batch-normalize
# [B, 1, 1, C] maps: at batch 2 each channel holds two values, normalized
# to +-1 whatever they are, so their gradients are rounding noise in both
# packages (JAX's lay 0.60 (median per tensor) from the port's float64 at
# 64x64); batch 8 conditions them.
SHAPES = {"re50_eca_nonlocal": (128, 2), "re152_4level": (128, 2), "epsa50_4level": (128, 2),
          "mnet_v3_4level": (64, 8)}


@pytest.mark.parametrize("preset", FAMILIES)
def test_train_step_matches_jax(preset):
    """One step from the same weights and batch (JAX: make_train_step, XLA
    matching; the port: make_train_step on the CPU), with the train tests'
    tolerances (tests/_torch_port_steps.py::assert_port_matches_jax)."""
    size, bsz = SHAPES[preset]
    kw = dict(KW, image_size=size, batch_size=bsz)
    variables = S.variables_for(size, seed=1, preset=preset)
    images, targets = level_batch(2, size, bsz)
    anchors = S.anchors_for(size, preset)
    want = S.jax_step(kw, variables, (images,), targets, anchors, preset)
    got = S.port_step(kw, variables, (torch.from_numpy(images),), targets, anchors, preset)
    # observed: gradients 2.5e-2 per tensor at worst (re152_4level), 1.1e-2
    # over all (re50_eca_nonlocal); BatchNorm statistics 1.6e-3 on values
    # up to 4.2e2
    S.assert_port_matches_jax(got, want)


@pytest.mark.parametrize("preset", ["re152_4level", "epsa50_4level"])
def test_remat_segments_give_the_plain_gradients(preset):
    """remat checkpoints the ResNet stem and every Bottleneck / EPSABlock as
    a segment: the train-mode gradients are the plain forward's, bit for
    bit."""
    tcfg = S.model_cfgs(preset)[1]
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 50, (2, 3, SIZE, SIZE)).astype(np.float32))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build_model(tcfg, mode="train", device="cpu")
        loc, cls, landm = model(x, remat=remat)
        (loc.square().sum() + cls.sum() + landm.abs().sum()).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and any("layer4_block0.conv1" in k for k in grads[0])
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def dropout_pair():
    jcfg = dataclasses.replace(JC.get_model_config("re50_dropout"), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config("re50_dropout"), compute_dtype="float32")
    variables = S.variables_for(SIZE, seed=3, preset="re50_dropout")
    x = np.random.default_rng(12).normal(0, 50, (2, SIZE, SIZE, 3)).astype(np.float32)
    return jcfg, tcfg, variables, x


def _port_train_forward(tcfg, variables, x, generator=None):
    model = build_model(tcfg, mode="train", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        return [h.numpy() for h in model.train()(to_nchw(x), generator=generator)]


def test_tap_dropout_eval_is_deterministic_and_matches_jax(dropout_pair):
    jcfg, tcfg, variables, x = dropout_pair
    from jabd_tpu.models import build_model as jax_build_model

    want = jax.jit(functools.partial(jax_build_model(jcfg, mode="eval").apply, train=False))(
        variables, jnp.asarray(x))
    model = build_model(tcfg, mode="eval", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        a, b = model.eval()(to_nchw(x)), model(to_nchw(x))
    for w, g, h in zip(want, a, b):
        assert torch.equal(g, h)
        # observed max error 1.4e-5 on heads up to 4.0; stated 1e-4 * max(1, max|ref|)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0)


def test_tap_dropout_train_mode_with_masks_forced_to_ones_matches_jax(dropout_pair, monkeypatch):
    """Train mode (batch statistics) with every keep mask forced to ones
    in both packages: the taps scaled by 1 / (1 - p) = 2 before the tap
    ECAs; the heads equal JAX's, and differ from the graph without
    dropout."""
    jcfg, tcfg, variables, x = dropout_pair
    from jabd_tpu.models import build_model as jax_build_model

    monkeypatch.setattr(flax.linen.stochastic.random, "bernoulli",
                        lambda rng, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(TR, "dropout_keep", lambda t, p, g: torch.ones(t.shape, dtype=torch.bool))
    apply = jax.jit(functools.partial(jax_build_model(jcfg, mode="train").apply, train=True, mutable=["batch_stats"]))
    want, _ = apply(variables, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)})
    got = _port_train_forward(tcfg, variables, x)
    plain = _port_train_forward(dataclasses.replace(tcfg, tap_dropout=0.0), variables, x)
    for w, g, p in zip(want, got, plain):
        # observed max error 1.9e-5 on heads up to 4.8; stated 1e-4 * max(1, max|ref|)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0)
        assert np.abs(g - p).max() > 1e-3


def test_tap_dropout_statistics_and_stream(dropout_pair):
    """Through the model in train mode: each tap reaching its ECA is the
    backbone's tap times 2 where kept and 0 elsewhere, with a drop share
    within 0.5 +- 0.01; the same (seed, step) draws the same masks, the
    next step others."""
    _, tcfg, variables, x = dropout_pair
    model = build_model(tcfg, mode="train", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    model.train()
    seen = {}
    hooks = [getattr(model, f"eca_tap{i + 1}").register_forward_pre_hook(
        lambda m, a, i=i: seen.__setitem__(i, a[0].clone())) for i in range(3)]
    raw = {}
    hooks.append(model.backbone.register_forward_hook(
        lambda m, a, out: raw.update(enumerate(t.clone() for t in out))))

    def draw(step):
        g = torch.Generator().manual_seed(ST.dropout_seed(7, step))
        with torch.no_grad():
            model(to_nchw(x), generator=g)
        return {i: t.clone() for i, t in seen.items()}

    first, again, other = draw(0), draw(0), draw(1)
    for h in hooks:
        h.remove()
    for i in range(3):
        live = raw[i] != 0  # after the backbone's ReLU
        kept = first[i] != 0
        share = 1.0 - float(kept[live].float().mean())
        assert abs(share - 0.5) <= 0.01, (i, share)
        assert torch.equal(first[i][kept], 2.0 * raw[i][kept])
        assert not kept[~live].any()
        assert torch.equal(first[i], again[i])
        assert not torch.equal(first[i], other[i])


def test_tap_dropout_train_step_uses_the_step_stream(dropout_pair):
    """Two port train steps at the same state.step from the same weights
    give identical gradients; at the next step, other ones."""
    _, tcfg, variables, _ = dropout_pair
    images, targets = _synthetic_batch(seed=4)
    anchors = torch.from_numpy(S.anchors_for(SIZE, "re50_dropout"))
    tgt = TLoss.Targets(*(torch.from_numpy(a) for a in targets))
    step = TT.make_train_step(tcfg, TC.TrainConfig(**KW, seed=3))

    def grads(at_step):
        model = build_model(tcfg, mode="train", device="cpu")
        model.load_state_dict(state_dict_from_flax(variables))
        state = TT.TrainState(model=model, optimizer=TT.make_optimizer(model.parameters(), 1e-3),
                              lr=1e-3, steps_per_epoch=1, gamma=0.92, step=at_step)
        step(state, torch.from_numpy(images), tgt, anchors)
        return {k: p.grad.clone() for k, p in model.named_parameters() if k.startswith("eca_tap")}

    a, b, c = grads(0), grads(0), grads(1)
    assert a.keys() == b.keys() and a
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_iou_head_is_refused_by_detection_and_training():
    """re50_iou_head builds (its fourth output is held against JAX in
    tests/test_torch_port_resnet.py); the Predictor and the train step,
    which take three outputs as in the JAX package, raise."""
    cfg = dataclasses.replace(TC.get_model_config("re50_iou_head"), compute_dtype="float32")
    model = build_model(cfg, mode="eval", device="cpu")
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 3, SIZE, SIZE))
    assert len(out) == 4 and out[3].shape == (1, out[0].shape[1], 1) and out[3].dtype == torch.float32
    with pytest.raises(ValueError, match="IoU head"):
        TP.Predictor(cfg, model.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="IoU head"):
        TT.make_train_step(cfg, TC.TrainConfig(**KW))
    with pytest.raises(ValueError, match="IoU head"):
        TT.fit(cfg, TC.TrainConfig(**KW), dataset=[], device="cpu")
