"""PyTorch port, int8 serving (models/quantize.py), against the JAX
package's `jabd_tpu/models/quantize.py` on the same folded weights:

- the calibration absmax of every ConvBN input agrees (rel 1e-5);
- on the same folded tree and calibration, the quantized sites, int8
  kernels, weight scales and activation scales are bit-equal;
- one QConv's int32 conv (the float64 plain version and the card's
  im2col + `_int_mm` route, run on the CPU) equals the JAX int conv of
  `qconv_apply` exactly, and its dequantized output matches;
- the heads of a quantized flagship and MobileNetV1-0.25 against JAX's
  quantized heads; `search_clip_ratio` picks JAX's ratio;
- an unfolded model quantizes nothing and raises; `Predictor.quantize_int8`.

Float32 at 64x64, one torch thread. The port's folded model takes the JAX
package's folded tree, so both quantize the same values.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.models import quantize as JQ
from jabd_tpu.models.fold import fold_batchnorm as jax_fold
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models import quantize as Q
from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables

SIZE = 64


def _setup(preset):
    jcfg = dataclasses.replace(JC.get_model_config(preset), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config(preset), compute_dtype="float32")
    jmodel = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))
    )
    variables = seeded_variables(shapes, seed=2)
    jfolded = jax_fold(variables)
    tmodel = fold_batchnorm(build_model(tcfg, mode="eval", device="cpu").eval())
    tmodel.load_state_dict(state_dict_from_flax(jfolded))
    x = np.random.default_rng(3).normal(0, 50, (2, SIZE, SIZE, 3)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, jfolded=jfolded, tmodel=tmodel, x=x)


@pytest.fixture(scope="module")
def flagship():
    return _setup("jabd_flagship")


@pytest.fixture(scope="module")
def mnet025():
    return _setup("retinaface_mnet025")


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_calib(jcalib):
    """The JAX calibration tree as the port's {module name: absmax}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcalib)[0]:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        assert keys[-1] == "x_absmax"
        name = ".".join(keys[:-1])
        out[name] = max(out.get(name, 0.0), float(np.max(np.asarray(leaf))))
    return out


def _jax_calib(s):
    return JQ.calibrate(s["jmodel"], s["jfolded"], [jnp.asarray(s["x"])])


def test_calibration_absmax_matches(flagship):
    want = _port_calib(_jax_calib(flagship))
    got = Q.calibrate(flagship["tmodel"], [_nchw(flagship["x"])])
    assert set(got) == set(want) and len(got) > 40
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


def _quantized_sites(params, prefix=()):
    for k, v in params.items():
        if isinstance(v, dict) and "qconv" in v:
            yield ".".join(prefix + (k,)), v["qconv"]
        elif isinstance(v, dict):
            yield from _quantized_sites(v, prefix + (k,))


@pytest.mark.parametrize("setup", ["flagship", "mnet025"])
def test_scales_and_kernels_bit_equal(request, setup):
    s = request.getfixturevalue(setup)
    jcalib = _jax_calib(s)
    qvars, n_jax = JQ.quantize_variables(s["jfolded"], jcalib)
    tmodel = copy.deepcopy(s["tmodel"])
    n = Q.quantize_model(tmodel, _port_calib(jcalib))
    want = dict(_quantized_sites(qvars["params"]))
    got = {name: m.conv for name, m in tmodel.named_modules() if isinstance(getattr(m, "conv", None), Q.QConv)}
    assert n == n_jax == len(want) and set(got) == set(want)
    for name, q in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.kernel_q.numpy(), np.asarray(q["kernel_q"]).transpose(3, 2, 0, 1), err_msg=name)
        np.testing.assert_array_equal(g.w_scale.numpy(), np.asarray(q["w_scale"]), err_msg=name)
        assert g.x_scale.numpy().tobytes() == np.asarray(q["x_scale"], np.float32).tobytes(), name
        np.testing.assert_array_equal(g.bias.numpy(), np.asarray(q["bias"]), err_msg=name)
    # Depthwise sites stay in float (mnet025's dw*_depth, the flagship's conv2s).
    assert all(m.conv.weight.shape[1] == 1 for _, m in tmodel.named_modules()
               if isinstance(getattr(m, "conv", None), torch.nn.Conv2d) and hasattr(m, "bn"))


@pytest.mark.parametrize(
    "cin,cout,k,stride,groups",
    [(5, 7, 3, 1, 1), (3, 16, 3, 2, 1), (16, 24, 1, 1, 1), (8, 12, 3, 1, 2)],
)
def test_qconv_int32_matches_jax(cin, cout, k, stride, groups):
    rng = np.random.default_rng(cin * cout)
    x = rng.normal(0, 1.2, (2, 9, 11, cin)).astype(np.float32)
    kern = rng.normal(0, 0.4, (k, k, cin // groups, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    absmax = float(np.abs(x).max())
    q = JQ._quantize_site({"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)}, absmax)
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
    qc = Q.quantize_site(conv, absmax)
    # JAX: qconv_apply's quantization and int conv, written out.
    xs = jnp.asarray(q["x_scale"], jnp.float32)
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127.0, 127.0).astype(jnp.int8)
    want = jax.lax.conv_general_dilated(
        x_q, q["kernel_q"], (stride, stride), ((k // 2, k // 2),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32,
    )
    want = np.asarray(want).transpose(0, 3, 1, 2)
    xq_t = qc.quantize_input(_nchw(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(x_q).transpose(0, 3, 1, 2))
    plain = qc.int_conv(xq_t)
    route = Q.int8_conv_mm(xq_t, qc.kernel_q, stride, k // 2, groups)
    assert plain.dtype == route.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(route.numpy(), want)
    got = qc(_nchw(x)).numpy()
    ref = np.asarray(JQ.qconv_apply(q, jnp.asarray(x), stride=stride, pad=k // 2, groups=groups,
                                    dtype=jnp.float32)).transpose(0, 3, 1, 2)
    # Dequantization y * scale + bias in float32 on both sides; XLA may
    # fuse it into one rounding. Observed max abs diff 0 in all four cases.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_int8_route_small_and_padded_shapes():
    """The im2col + _int_mm route pads M to 17 and K, N to multiples of 8;
    exact against the plain version where each pad is needed."""
    rng = np.random.default_rng(0)
    for b, c, h, o, k, s in ((1, 3, 4, 5, 3, 2), (2, 27, 3, 9, 1, 1), (1, 1, 8, 8, 3, 1)):
        xq = torch.from_numpy(rng.integers(-127, 128, (b, c, h, h), dtype=np.int8))
        kq = torch.from_numpy(rng.integers(-127, 128, (o, c, k, k), dtype=np.int8))
        assert torch.equal(Q.int8_conv_mm(xq, kq, s, k // 2, 1), Q.int8_conv_plain(xq, kq, s, k // 2, 1))


@pytest.mark.parametrize("setup", ["flagship", "mnet025"])
def test_quantized_heads_match_jax(request, setup):
    """Same folded weights, same calibration: the quantized heads. The
    float32 activations between the sites differ by rounding noise, and an
    activation at a rounding boundary could round the other way in one
    package (one int8 step at one site); observed max abs diff 9.5e-7
    (flagship, max |head| 3.7), 6.0e-8 (mnet025), so no site flipped."""
    s = request.getfixturevalue(setup)
    jcalib = _jax_calib(s)
    qvars, _ = JQ.quantize_variables(s["jfolded"], jcalib)
    want = s["jmodel"].apply(qvars, jnp.asarray(s["x"]), train=False)
    tmodel = copy.deepcopy(s["tmodel"])
    Q.quantize_model(tmodel, _port_calib(jcalib))
    with torch.no_grad():
        got = tmodel(_nchw(s["x"]))
    for name, g, w in zip(("loc", "cls", "landm"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w)
        assert err.max() <= 1e-5 * max(1.0, np.abs(w).max()), (name, err.max())


def test_search_clip_ratio_matches_jax(flagship):
    s = flagship
    jcalib = _jax_calib(s)
    best_j, errs_j = JQ.search_clip_ratio(s["jmodel"], s["jfolded"], jcalib, [jnp.asarray(s["x"])])
    best_t, errs_t = Q.search_clip_ratio(s["tmodel"], _port_calib(jcalib), [_nchw(s["x"])])
    assert best_t == best_j
    assert set(errs_t) == set(errs_j)
    # Observed: six ratios agree to 1e-6 relative, ratio 0.85 to 1.0% (an
    # activation that rounds the other way at one site, downstream of
    # float32 noise); the choice itself must be the same.
    for r in errs_j:
        np.testing.assert_allclose(errs_t[r], errs_j[r], rtol=2e-2)
    assert not any(isinstance(m, Q.QConv) for m in s["tmodel"].modules())  # the float model is untouched


def test_unfolded_model_quantizes_nothing(flagship):
    model = build_model(flagship["tcfg"], mode="eval", device="cpu").eval()
    model.load_state_dict(state_dict_from_flax(flagship["variables"]))
    calib = Q.calibrate(model, [_nchw(flagship["x"])])
    assert calib
    with pytest.raises(ValueError, match="no quantizable ConvBN"):
        Q.quantize_model(model, calib)
    with pytest.raises(ValueError, match="no batches"):
        Q.calibrate(model, [])


def test_predictor_quantize_int8(flagship):
    """Calibration frames through the serving recipe: the same number of
    sites as the JAX Predictor quantizes, and finite detections."""
    pcfg = dict(confidence=0.02, input_shape=(SIZE, SIZE), max_detections=32, pre_nms_topk=128)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    jp = JPredictor(flagship["jcfg"], flagship["variables"], JC.PredictConfig(**pcfg), use_pallas=False)
    tp = Predictor(flagship["tcfg"], state_dict_from_flax(flagship["variables"]), TC.PredictConfig(**pcfg),
                   device="cpu")
    assert tp.quantize_int8(imgs) == jp.quantize_int8(imgs)
    assert sum(isinstance(m, Q.QConv) for m in tp.model.modules()) > 40
    dets = tp.detect_image(imgs[0])
    assert dets.ndim == 2 and dets.shape[1] == 15 and np.isfinite(dets).all()
