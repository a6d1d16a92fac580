"""One train step of the JAX package and of the port from the same weights
and batch, for the port's train-mode tests (remat, microbatches, device
augmentation). The JAX step is `jabd_tpu.train.make_train_step` itself;
its optimizer records the gradients it is given and updates nothing (as in
tests/test_torch_port_train.py), so one call yields the metrics, the
gradients and the new BatchNorm statistics."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import losses as JL
from jabd_tpu import train as JT
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.ops import anchors as JA
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_model import seeded_variables
from tests.test_torch_port_train import _grad_errors, _leaves, _record_grads, _tree

PRESET = "jabd_flagship"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread while a module's tests run: the suite runs
    several test processes at once, and torch's default of one thread per
    core in each of them oversubscribes the cores many times over (whole
    files ran several times slower). Import it into a test module to use
    it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_cfgs(preset=PRESET):
    jcfg = dataclasses.replace(JC.get_model_config(preset), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config(preset), compute_dtype="float32")
    return jcfg, tcfg


def variables_for(size, seed=1, preset=PRESET):
    model = jax_build_model(model_cfgs(preset)[0], mode="train")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32),
    )
    return seeded_variables(shapes, seed=seed)


def anchors_for(size, preset=PRESET):
    return JA.generate_anchors(model_cfgs(preset)[0].anchors, (size, size)).copy()


def jax_step(train_kw, variables, inputs, targets, anchors, preset=PRESET):
    """inputs: (images,) or (images_u8, plan) as numpy."""
    jcfg = model_cfgs(preset)[0]
    tx = _record_grads()
    state = JT.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        tx=tx,
    )
    step = JT.make_train_step(jcfg, JC.TrainConfig(**train_kw))
    new_state, metrics = step(
        state, *(jax.tree_util.tree_map(jnp.asarray, x) for x in inputs),
        JL.Targets(*(jnp.asarray(a) for a in targets)), jnp.asarray(anchors),
    )
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": dict(_leaves(_tree(new_state.opt_state))),
        "batch_stats": dict(_leaves(_tree(new_state.batch_stats))),
    }


def port_step(train_kw, variables, inputs, targets, anchors, preset=PRESET):
    """inputs: (images,) or (images_u8, plan) as torch CPU tensors."""
    tcfg = model_cfgs(preset)[1]
    model = build_model(tcfg, mode="train", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    state = TT.TrainState(
        model=model, optimizer=TT.make_optimizer(model.parameters(), 1e-3),
        lr=1e-3, steps_per_epoch=1, gamma=0.92,
    )
    step = TT.make_train_step(tcfg, TC.TrainConfig(**train_kw))
    state, metrics = step(
        state, *inputs, TL.Targets(*(torch.from_numpy(a) for a in targets)), torch.from_numpy(anchors)
    )
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    grads = {k: p.grad for k, p in model.named_parameters()}
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": dict(_leaves(flax_from_state_dict({**grads, **stats})["params"])),
        "batch_stats": dict(_leaves(flax_from_state_dict(model.state_dict())["batch_stats"])),
        "state": state,
    }


def assert_port_matches_jax(got, want, stats_atol=1e-5):
    """The tolerances of tests/test_torch_port_train.py: loss terms 1e-5
    relative; gradients 5e-2 per tensor and 2e-2 over all (JAX's own
    float32 error); BatchNorm statistics 1e-4 of the value + stats_atol."""
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5, err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    per, total = _grad_errors(got["grads"], want["grads"])
    assert len(per) > 0.9 * len(want["grads"])
    assert max(per.values()) < 5e-2, max(per.items(), key=lambda kv: kv[1])
    assert total < 2e-2, total
    assert got["batch_stats"].keys() == want["batch_stats"].keys()
    for path, w in want["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][path], w, rtol=1e-4, atol=stats_atol, err_msg=str(path))
    return per, total


def assert_ports_identical(a, b):
    """Two port steps that must agree bit for bit."""
    assert a["metrics"] == b["metrics"]
    for part in ("grads", "batch_stats"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")
