"""PyTorch port, the IR backbones' BatchNorm folding (recognition/fold.py)
and int8 path (models/quantize.py: the flat layout and `QDense`), against
the JAX package's `fold_ir`, `calibrate`, `quantize_variables` and
`qdense_apply`, on ir_18 with seeded weights at 112x112, float32:

- `fold_ir`: the folded tree equal to JAX's within 1e-6 of each leaf's
  largest value (XLA may fuse the bias's multiply-add: observed 7e-9 on a
  bias of 0.003), and folded embeddings equal to the unfolded ones;
- calibration absmax of every site within rel 1e-5; on the same folded
  tree and calibration, the quantized sites (convs and `fc`), int8
  kernels and scales bit-equal;
- the int32 sums of a QConv and of the QDense exact on both routes (the
  float64 plain version and `_int_mm`, run on the CPU) against JAX's;
- `QDense` against `qdense_apply`; int8 embeddings against JAX's int8
  embeddings (cosine > 0.999), and within the JAX package's cosine bound
  (0.98) of the float model's;
- an unfolded backbone quantizes its `fc` only, as the JAX package does.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.models import quantize as JQ
from jabd_tpu.recognition import net as JN
from jabd_tpu.recognition.fold import fold_ir as jax_fold_ir
from jabd_tpu_torch.models import quantize as Q
from jabd_tpu_torch.recognition import build_model
from jabd_tpu_torch.recognition.fold import fold_ir
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables


@pytest.fixture(scope="module")
def setup():
    jmodel = JN.build_model("ir_18")
    x = np.random.default_rng(1).normal(0, 1, (2, 112, 112, 3)).astype(np.float32)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_variables(shapes, seed=9)
    jfolded = jax_fold_ir(variables)
    tmodel = fold_ir(build_model("ir_18", device="cpu"))
    tmodel.load_state_dict(state_dict_from_flax(jfolded))
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    jcalib = JQ.calibrate(jmodel, jfolded, [jnp.asarray(x)])
    return dict(jmodel=jmodel, variables=variables, jfolded=jfolded, tmodel=tmodel, x=x, apply=apply,
                jcalib=jcalib)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_calib(jcalib):
    """The JAX flat calibration tree ({block: {"conv1_absmax": ...}},
    "fc_absmax" at the root) as the port's {module name: absmax}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcalib)[0]:
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        name = ".".join(keys[:-1] + [keys[-1].removesuffix("_absmax")])
        out[name] = float(np.max(np.asarray(leaf)))
    return out


def test_fold_ir_matches_jax(setup):
    unfolded = build_model("ir_18", device="cpu")
    unfolded.load_state_dict(state_dict_from_flax(setup["variables"]))
    with torch.no_grad():
        want_e = unfolded(_nchw(setup["x"]))[0].numpy()
    fold_ir(unfolded)
    got = flax_from_state_dict(unfolded.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(setup["jfolded"])
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(node, leaf, rtol=0, atol=1e-6 * np.abs(leaf).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert "features_bn" not in got["batch_stats"] and "bn1" not in got["params"]["stage1_block0"]
    with torch.no_grad():
        got_e = unfolded(_nchw(setup["x"]))[0].numpy()
    np.testing.assert_allclose(got_e, want_e, rtol=0, atol=1e-5)
    jax_e = np.asarray(setup["apply"](setup["jfolded"], jnp.asarray(setup["x"]))[0])
    np.testing.assert_allclose(got_e, jax_e, rtol=0, atol=1e-5)


def test_calibration_absmax_matches(setup):
    want = _port_calib(setup["jcalib"])
    got = Q.calibrate(setup["tmodel"], [_nchw(setup["x"])])
    assert set(got) == set(want) and "fc" in got and "input_conv" in got and len(got) == 21
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


def _jax_sites(params, prefix=()):
    for k, v in params.items():
        if isinstance(v, dict) and "kernel_q" in v:
            yield ".".join(prefix + (k,)), v
        elif isinstance(v, dict):
            yield from _jax_sites(v, prefix + (k,))


@pytest.fixture(scope="module")
def quantized(setup):
    qvars, n_jax = JQ.quantize_variables(setup["jfolded"], setup["jcalib"])
    tmodel = copy.deepcopy(setup["tmodel"])
    n = Q.quantize_model(tmodel, _port_calib(setup["jcalib"]))
    return dict(qvars=qvars, n_jax=n_jax, tmodel=tmodel, n=n)


def test_scales_and_kernels_bit_equal(quantized):
    want = dict(_jax_sites(quantized["qvars"]["params"]))
    got = {n: m for n, m in quantized["tmodel"].named_modules() if isinstance(m, (Q.QConv, Q.QDense))}
    assert quantized["n"] == quantized["n_jax"] == len(want) == 21 and set(got) == set(want)
    assert isinstance(got["fc"], Q.QDense)
    for name, q in want.items():
        g = got[name]
        k = np.asarray(q["kernel_q"])
        k = k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(g.kernel_q.numpy(), k, err_msg=name)
        np.testing.assert_array_equal(g.w_scale.numpy(), np.asarray(q["w_scale"]), err_msg=name)
        assert g.x_scale.numpy().tobytes() == np.asarray(q["x_scale"], np.float32).tobytes(), name
        np.testing.assert_array_equal(g.bias.numpy(), np.asarray(q["bias"]), err_msg=name)


def test_int32_sums_exact_on_both_routes(quantized, rng):
    model = quantized["tmodel"]
    conv = model.stage2_block0.conv2  # a stride-2 3x3 site
    x = torch.from_numpy(rng.normal(0, 1, (2, 128, 28, 28)).astype(np.float32))
    xq = conv.quantize_input(x)
    plain = conv.int_conv(xq)
    mm = Q.int8_conv_mm(xq, conv.kernel_q, conv.stride, conv.padding, conv.groups)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq.permute(0, 2, 3, 1).numpy()), jnp.asarray(conv.kernel_q.permute(2, 3, 1, 0).numpy()),
        (2, 2), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(mm.numpy(), plain.numpy())
    fc = model.fc
    h = torch.from_numpy(rng.normal(0, 1, (3, fc.kernel_q.shape[1])).astype(np.float32))
    hq = fc.quantize_input(h)
    want = jnp.dot(jnp.asarray(hq.numpy()), jnp.asarray(fc.kernel_q.numpy().T), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(fc.int_matmul(hq).numpy(), np.asarray(want))
    np.testing.assert_array_equal(Q.int8_matmul_mm(hq, fc.kernel_q).numpy(), np.asarray(want))


def test_qdense_matches_qdense_apply(quantized, rng):
    q = quantized["qvars"]["params"]["fc"]
    h = rng.normal(0, 1, (4, q["kernel_q"].shape[0])).astype(np.float32)
    want = np.asarray(JQ.qdense_apply(q, jnp.asarray(h), jnp.float32))
    with torch.no_grad():
        got = quantized["tmodel"].fc(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_embeddings_match_jax(setup, quantized):
    want = np.asarray(setup["apply"](quantized["qvars"], jnp.asarray(setup["x"]))[0])
    with torch.no_grad():
        got = quantized["tmodel"](_nchw(setup["x"]))[0].numpy()
        ref = setup["tmodel"](_nchw(setup["x"]))[0].numpy()
    cos_jax, cos_float = np.sum(got * want, axis=1), np.sum(got * ref, axis=1)
    print(f"cosine to JAX int8 {cos_jax}, to float {cos_float}, max abs err {np.abs(got - want).max():.3e}")
    # An activation that differs from JAX's by float32 rounding can round to
    # the neighbouring int8 level, and 21 sites compound it: observed
    # cosines 0.99996 and 0.99956 (int8 against float: 0.9984).
    assert np.all(cos_jax > 0.999)
    assert np.all(cos_float > 0.98)


def test_unfolded_ir_quantizes_only_fc(setup):
    """The JAX flat layout quantizes a Dense whatever the fold (its kernel
    always has a bias) and no unfolded conv; so does the port."""
    model = build_model("ir_18", device="cpu")
    model.load_state_dict(state_dict_from_flax(setup["variables"]))
    calib = Q.calibrate(model, [_nchw(setup["x"])])
    assert Q.quantize_model(model, calib) == 1 and isinstance(model.fc, Q.QDense)
