"""PyTorch port, detector modules against their flax twins at float32:
ECA, NLM, SSH, MNV3Block, the cascade FPN at odd sizes, the whole
jabd_flagship graph, BatchNorm folding and the weight conversion.

Weights are made once, on the JAX side, from numpy seeds and carried
across with `utils/convert.py`. For the flagship, the parameter tree's
shapes come from `jax.eval_shape(model.init)`: jitting the init costs
about a minute of one core, the shapes alone a few seconds, and seeded
values also give the BatchNorms a non-trivial state and the NLM a
non-zero output projection, which `init` leaves at identity.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.models import layers as JL
from jabd_tpu.models.mobilenet import MNV3Block as JBlock
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models import layers as TL
from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.models.mobilenet import MNV3Block
from jabd_tpu_torch.utils.convert import state_dict_from_flax


def seeded_variables(shapes, seed: int):
    """numpy values for a flax variables tree of ShapeDtypeStructs (or
    arrays): kernels N(0, 1/fan_in) (head kernels 0.1 times that),
    biases N(0, 0.1^2), BatchNorm scale 1 + N(0, 0.1^2), mean
    N(0, 0.1^2), var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            if any("head" in k for k in keys):
                std *= 0.1
            v = rng.normal(0, std, shape)
        elif keys[-1] == "scale":
            v = 1 + rng.normal(0, 0.1, shape)
        elif keys[-1] == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def flagship_variables(cfg, hw, seed=0):
    model = jax_build_model(cfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        jax.random.PRNGKey(0),
        jnp.zeros((1, *hw, 3), jnp.float32),
    )
    return model, seeded_variables(shapes, seed)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _module_pair(jmod, tmod, x, seed=0, **apply_kw):
    """Init the flax module, reseed its values, load them into the torch
    module; return (flax out, torch out) on x (NHWC numpy)."""
    shapes = jax.eval_shape(
        functools.partial(jmod.init, **apply_kw), jax.random.PRNGKey(0), jnp.asarray(x)
    )
    v = seeded_variables(shapes, seed)
    want = jax.jit(functools.partial(jmod.apply, **apply_kw))(v, jnp.asarray(x))
    tmod.load_state_dict(state_dict_from_flax(v))
    tmod.eval()
    with torch.no_grad():
        got = tmod(to_nchw(x))
    return want, got


@pytest.mark.parametrize("statistic", ["avg", "stdv"])
@pytest.mark.parametrize("gate", ["sigmoid", "hsigmoid"])
@pytest.mark.parametrize("channels", [40, 160])
def test_eca(rng, statistic, gate, channels):
    x = rng.normal(0, 2, (2, 9, 7, channels)).astype(np.float32)
    x[0, :, :, 3] = 1.5  # a spatially constant channel: stdv exactly 0
    want, got = _module_pair(
        JL.ECA(statistic=statistic, gate=gate), TL.ECA(channels, statistic, gate), x
    )
    # observed max error 7.2e-7
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("psp", [(1, 3, 6, 8), (1, 4, 8, 12)])
def test_nlm(rng, psp):
    x = rng.normal(0, 1, (2, 11, 13, 16)).astype(np.float32)
    want, got = _module_pair(JL.NLM(ch=8, psp_sizes=psp), TL.NLM(16, 8, psp), x)
    # observed max error 9.5e-7; W is seeded non-zero, so attention is live
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(want) - x).max() > 1e-2


@pytest.mark.parametrize("out_channels", [40, 128])  # LeakyReLU 0.1 / ReLU
def test_ssh(rng, out_channels):
    x = rng.normal(0, 1, (2, 10, 9, 24)).astype(np.float32)
    want, got = _module_pair(
        JL.SSH(out_channels), TL.SSH(24, out_channels), x, train=False
    )
    # observed max error 1.2e-6
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


BLOCKS = {
    # (kernel, in, expand, out, act, se, stride, eca)
    "s1_in_ne_out_eca": (3, 24, 72, 40, "relu", False, 1, "avg"),
    "s2_in_ne_out_stdv": (5, 24, 72, 40, "hswish", True, 2, "stdv"),
    "s2_in_eq_out_se": (3, 40, 120, 40, "hswish", True, 2, None),
    "s1_identity_plain": (3, 16, 16, 16, "relu", False, 1, None),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_mnv3_block(rng, name):
    k, cin, exp, cout, act, se, stride, eca = BLOCKS[name]
    x = rng.normal(0, 1, (2, 10, 10, cin)).astype(np.float32)
    jblk = JBlock(kernel=k, in_size=cin, expand=exp, out=cout, act=act, se=se,
                  stride=stride, eca=eca)
    tblk = MNV3Block(k, cin, exp, cout, act, se, stride, eca)
    want, got = _module_pair(jblk, tblk, x, train=False)
    # observed max error 9.5e-7
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    unfolded = got
    fold_batchnorm(tblk)
    with torch.no_grad():
        folded = tblk(to_nchw(x))
    # observed max error 1.4e-6
    np.testing.assert_allclose(folded.numpy(), unfolded.numpy(), atol=3e-5, rtol=0)


@pytest.mark.parametrize("upsample", ["bicubic", "nearest"])
def test_fpn_cascade_at_odd_sizes(rng, upsample):
    """Pyramid sizes are not always x2: 105/53/27 at 840x840."""
    taps = [
        rng.normal(0, 1, (2, h, h, c)).astype(np.float32)
        for h, c in ((27, 8), (14, 12), (7, 16))
    ]
    jfpn = JL.FPN(out_channels=16, upsample=upsample, nlm_ch=8)
    tfpn = TL.FPN((8, 12, 16), 16, upsample=upsample, nlm_ch=8)
    jt = [jnp.asarray(t) for t in taps]
    shapes = jax.eval_shape(functools.partial(jfpn.init, train=False), jax.random.PRNGKey(0), jt)
    v = seeded_variables(shapes, 3)
    want = jax.jit(functools.partial(jfpn.apply, train=False))(v, jt)
    tfpn.load_state_dict(state_dict_from_flax(v))
    tfpn.eval()
    with torch.no_grad():
        got = tfpn([to_nchw(t) for t in taps])
    for w, g in zip(want, got):
        # observed max error 2.9e-6
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def flagship():
    cfg = dataclasses.replace(JC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model, variables = flagship_variables(cfg, (64, 64))
    x = np.random.default_rng(7).normal(0, 50, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(functools.partial(model.apply, train=False))(variables, jnp.asarray(x))
    tcfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    tmodel = build_model(tcfg, mode="eval", device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables))  # strict: every name maps
    tmodel.eval()
    return x, [np.asarray(r) for r in ref], tmodel


def test_flagship_matches_jax(flagship):
    x, ref, tmodel = flagship
    with torch.no_grad():
        got = tmodel(to_nchw(x))
    for name, r, g, d in zip(("loc", "cls", "landm"), ref, got, (4, 2, 10)):
        assert g.shape == (2, 168, d) and g.dtype == torch.float32, name
        # observed max error 8.5e-6; stated tolerance 1e-4
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_retinaface_mnet025_matches_jax(remat):
    """The MobileNetV1-0.25 preset (backbone, nearest-upsample FPN, SSH,
    heads) against its flax twin at random weights, 96x80; the remat
    segments give the same heads."""
    cfg = dataclasses.replace(JC.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    model, variables = flagship_variables(cfg, (96, 80), seed=2)
    x = np.random.default_rng(8).normal(0, 50, (2, 96, 80, 3)).astype(np.float32)
    ref = jax.jit(functools.partial(model.apply, train=False))(variables, jnp.asarray(x))
    tcfg = dataclasses.replace(TC.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    tmodel = build_model(tcfg, mode="eval", device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(to_nchw(x), remat=remat)
    for name, r, g in zip(("loc", "cls", "landm"), ref, got):
        assert g.shape == np.asarray(r).shape, name
        # observed max error 8.9e-8; stated tolerance 1e-4
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0, err_msg=name)


def test_retinaface_mnet025_remat_gives_the_plain_gradients():
    """Training mode: remat's segments recompute the MobileNetV1 blocks in
    backward; the gradients are the plain forward's, bit for bit."""
    tcfg = dataclasses.replace(TC.get_model_config("retinaface_mnet025"), compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 50, (2, 3, 64, 64)).astype(np.float32))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build_model(tcfg, mode="train", device="cpu")
        loc, cls, landm = model(x, remat=remat)
        (loc.square().sum() + cls.sum() + landm.abs().sum()).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and any("dw12_point" in k for k in grads[0])
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0, msg=k)


def test_flagship_fold_matches_unfolded(flagship):
    x, _, tmodel = flagship
    folded = build_model(tmodel.cfg, mode="eval", device="cpu")
    folded.load_state_dict(tmodel.state_dict())
    fold_batchnorm(folded.eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    with torch.no_grad():
        ref = tmodel(to_nchw(x))
        got = folded(to_nchw(x))
    for r, g in zip(ref, got):
        # observed max error 5.2e-6; stated tolerance 3e-5
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=3e-5, rtol=0)


def test_flagship_bfloat16_runs(flagship):
    """The preset's bfloat16 graph (folded, then cast) gives float32
    heads near the float32 ones."""
    x, _, tmodel = flagship
    m16 = build_model(TC.get_model_config("jabd_flagship"), mode="eval", device="cpu")
    m16.load_state_dict(tmodel.state_dict())
    fold_batchnorm(m16.eval()).to(torch.bfloat16)
    with torch.no_grad():
        ref = tmodel(to_nchw(x))
        got = m16(to_nchw(x))
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert float((got[1] - ref[1]).abs().max()) < 0.25  # class probabilities


@pytest.mark.parametrize("name", sorted(TC.MODEL_PRESETS))
def test_build_model_state_dict_names_mirror_flax(name):
    """Every preset's state dict, at full depth, has exactly the flax
    paths and shapes (from jax.eval_shape: no JIT)."""
    cfg = dataclasses.replace(JC.get_model_config(name), compute_dtype="float32")
    model = jax_build_model(cfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3), jnp.float32),
    )
    sd = state_dict_from_flax(seeded_variables(shapes, 0))
    tmodel = build_model(TC.get_model_config(name), device="cpu")
    assert set(sd) == set(tmodel.state_dict())
    for key, value in tmodel.state_dict().items():
        assert tuple(sd[key].shape) == tuple(value.shape), key


def test_build_model_refuses_eca_g_with_four_levels():
    """The one configuration the JAX package refuses: eca_g block
    attention's indices are the 3-stage split's."""
    cfg = dataclasses.replace(TC.get_model_config("mnet_v3_4level"), backbone_block_attention="eca_g")
    jcfg = dataclasses.replace(JC.get_model_config("mnet_v3_4level"), backbone_block_attention="eca_g")
    with pytest.raises(ValueError, match="eca_g") as port_err:
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="eca_g") as jax_err:
        jax_build_model(jcfg)
    assert str(port_err.value) == str(jax_err.value)
