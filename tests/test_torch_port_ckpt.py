"""PyTorch port, portable weights and the training log on the CPU:
`utils/np_ckpt.py` against `jabd_tpu/utils/np_ckpt.py` in both directions
(jabd_flagship at 64x64, forward outputs after the trip), the committed
trained fixture `ckpt_retinaface_r_96.npz` in the port, `partial_load`
against the JAX package's on a head-shape mismatch, and the loss plot."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.utils import checkpoint as JCK
from jabd_tpu.utils import np_ckpt as JNP
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.utils import np_ckpt as TNP
from jabd_tpu_torch.utils.checkpoint import partial_load
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from jabd_tpu_torch.utils.logging import LossHistory
from tests.test_torch_port_model import flagship_variables, seeded_variables, to_nchw
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trained_parity", "ckpt_retinaface_r_96.npz")


def _cfgs(preset):
    return (dataclasses.replace(JC.get_model_config(preset), compute_dtype="float32"),
            dataclasses.replace(TC.get_model_config(preset), compute_dtype="float32"))


@pytest.fixture(scope="module")
def flagship():
    jcfg, tcfg = _cfgs("jabd_flagship")
    model, variables = flagship_variables(jcfg, (64, 64), seed=3)
    x = np.random.default_rng(5).normal(0, 50, (2, 64, 64, 3)).astype(np.float32)
    ref = [np.asarray(r) for r in jax.jit(functools.partial(model.apply, train=False))(variables, jnp.asarray(x))]
    return tcfg, variables, x, ref


def _port_heads(tcfg, state, x):
    m = build_model(tcfg, mode="eval", device="cpu")
    m.load_state_dict(state)
    with torch.no_grad():
        return [h.numpy() for h in m.eval()(to_nchw(x))]


def test_jax_written_npz_loads_in_the_port(tmp_path, flagship):
    tcfg, variables, x, ref = flagship
    path = str(tmp_path / "jax.npz")
    JNP.save_variables_npz(path, variables)
    template = build_model(tcfg, mode="eval", device="cpu").state_dict()
    state = TNP.load_variables_npz(path, template)
    assert state.keys() == template.keys()
    want = state_dict_from_flax(variables)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    for g, r in zip(_port_heads(tcfg, state, x), ref):
        # the model test's tolerance (observed 8.5e-6 there)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("params_dtype", [None, np.float16])
def test_port_written_npz_loads_in_jax(tmp_path, flagship, params_dtype):
    tcfg, variables, x, ref = flagship
    state = state_dict_from_flax(variables)
    path = str(tmp_path / "port.npz")
    TNP.save_variables_npz(path, state, params_dtype=params_dtype)
    with np.load(path) as z:
        want_keys = set(JNP.flatten_tree(variables["params"], "params")) | set(
            JNP.flatten_tree(variables["batch_stats"], "batch_stats"))
        assert set(z.files) == want_keys
        assert {z[k].dtype for k in z.files if k.startswith("params")} == {np.dtype(params_dtype or np.float32)}
        assert {z[k].dtype for k in z.files if k.startswith("batch_stats")} == {np.dtype(np.float32)}
    loaded = JNP.load_variables_npz(path, variables)
    got = JNP.flatten_tree(loaded)
    for k, v in JNP.flatten_tree(variables).items():
        if params_dtype is not None and k.startswith("['params']"):
            v = v.astype(params_dtype).astype(np.float32)
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if params_dtype is None:
        jcfg = _cfgs("jabd_flagship")[0]
        out = jax.jit(functools.partial(jax_build_model(jcfg, mode="eval").apply, train=False))(loaded, jnp.asarray(x))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(np.asarray(o), r)
        # and back into the port: the same arrays
        back = TNP.load_variables_npz(path, state)
        assert all(torch.equal(back[k], v) for k, v in state.items() if "num_batches" not in k)


def test_load_checks_keys_and_shapes(tmp_path, flagship):
    tcfg, variables, _, _ = flagship
    state = state_dict_from_flax(variables)
    path = str(tmp_path / "w.npz")
    TNP.save_variables_npz(path, state)
    other = build_model(_cfgs("mnet_v3_plain")[1], mode="eval", device="cpu").state_dict()
    with pytest.raises((KeyError, ValueError)):
        TNP.load_variables_npz(path, other)
    bigger = dict(state)
    key = "fpn.output1.conv.weight"
    bigger[key] = torch.zeros((bigger[key].shape[0] + 1,) + tuple(bigger[key].shape[1:]))
    with pytest.raises(ValueError, match="shape"):
        TNP.load_variables_npz(path, bigger)
    with pytest.raises(KeyError, match="missing"):
        TNP.load_variables_npz(path, {**state, "extra.running_mean": torch.zeros(3)})


def test_trained_fixture_loads_into_the_port():
    """The committed trained retinaface_r (424 arrays, float16 parameters):
    the port's heads on a seeded 96x96 batch against the JAX package's."""
    jcfg, tcfg = _cfgs("retinaface_r")
    model = jax_build_model(jcfg, mode="eval")
    template = jax.eval_shape(lambda r, x: model.init(r, x, train=False), jax.random.PRNGKey(0),
                              jnp.zeros((1, 96, 96, 3), jnp.float32))
    variables = JNP.load_variables_npz(FIXTURE, template)
    port = build_model(tcfg, mode="eval", device="cpu")
    state = TNP.load_variables_npz(FIXTURE, port.state_dict())
    with np.load(FIXTURE) as z:
        assert len(z.files) == 424
        assert sum(z[k].size for k in z.files) == sum(
            v.numel() for k, v in state.items() if "num_batches" not in k)
    x = np.random.default_rng(2).normal(0, 50, (2, 96, 96, 3)).astype(np.float32)
    ref = jax.jit(functools.partial(model.apply, train=False))(variables, jnp.asarray(x))
    for g, r in zip(_port_heads(tcfg, state, x), ref):
        # the model test's tolerance
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=0)


def test_partial_load_matches_jax_on_a_head_mismatch():
    """A flagship with three anchors per cell instead of two: every entry
    but the heads' last convs loads, in both packages alike."""
    jcfg, tcfg = _cfgs("jabd_flagship")
    jcfg3 = dataclasses.replace(jcfg, anchors_per_cell=3)
    tcfg3 = dataclasses.replace(tcfg, anchors_per_cell=3)

    def shapes(cfg):
        m = jax_build_model(cfg, mode="eval")
        return jax.eval_shape(functools.partial(m.init, train=False), jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3), jnp.float32))

    source = seeded_variables(shapes(jcfg), seed=1)
    target = seeded_variables(shapes(jcfg3), seed=2)
    merged, n_jax = JCK.partial_load(target["params"], source["params"])
    assert 0 < n_jax < len(jax.tree_util.tree_leaves(target["params"]))

    t_target = state_dict_from_flax(target)
    t_source = state_dict_from_flax(source)
    got, n_port = partial_load(t_target, t_source)
    assert set(got) == set(t_target)
    params = {k for k, _ in build_model(tcfg3, mode="eval", device="cpu").named_parameters()}
    n_params = sum(1 for k in params if got[k] is t_source.get(k))
    assert n_params == n_jax
    want = state_dict_from_flax({"params": merged, "batch_stats": target["batch_stats"]})
    for k in params:
        assert torch.equal(got[k], want[k]), k
    skipped = sorted(k for k in params if got[k] is t_target[k])
    assert skipped and all("head" in k for k in skipped), skipped
    # Buffers load too (BatchNorm statistics of the same shapes).
    assert n_port > n_params
    model = build_model(tcfg3, mode="eval", device="cpu")
    model.load_state_dict(got)


def test_loss_history_writes_the_plot(tmp_path):
    hist = LossHistory(str(tmp_path))
    for v in (5.0, 4.0, 3.5, 3.0, 2.8, 2.7, 2.5, 2.4):  # >= 7: the savgol line too
        hist.append_loss(v)
    assert os.path.getsize(os.path.join(hist.save_path, "epoch_loss.png")) > 0
    assert open(os.path.join(hist.save_path, "epoch_loss.txt")).read().split() == [
        "5.0", "4.0", "3.5", "3.0", "2.8", "2.7", "2.5", "2.4"]


def test_loss_history_without_matplotlib_writes_the_txt(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    hist = LossHistory(str(tmp_path))
    hist.append_loss(1.0)
    hist.append_loss(0.5)
    assert not hist.plot
    assert not os.path.exists(os.path.join(hist.save_path, "epoch_loss.png"))
    assert open(os.path.join(hist.save_path, "epoch_loss.txt")).read().split() == ["1.0", "0.5"]
