"""PyTorch port, the IR / IR-SE embedders (recognition/net.py) against the
JAX package's flax modules, on the CPU in float32, from the same seeded
weights (tests/test_torch_port_model.py::seeded_variables):

- `BasicBlockIR` and `BottleneckIRBlock`, with and without SE, at stride 1
  and 2, with the slice shortcut (channels kept) and the conv shortcut;
- the whole ir_18 and ir_se_18 at 112x112, bs 2: embeddings and norms;
- the state-dict names and shapes of all 12 names against the flax trees
  of `jax.eval_shape` (the port's models built on the meta device);
- `state_dict_from_flax` <-> `flax_from_state_dict` on an IR tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.recognition import net as JN
from jabd_tpu_torch.recognition import net as TN
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables


def _init_shapes(module, x):
    return jax.eval_shape(functools.partial(module.init, train=False), jax.random.PRNGKey(0), x)


def _port(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_flax(variables))
    return module.eval()


@pytest.mark.parametrize("shortcut", ["slice", "conv"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("se", [False, True])
@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_block_matches_flax(kind, se, stride, shortcut, rng):
    depth = 32
    cin = depth if shortcut == "slice" else 16
    jcls, tcls = {"basic": (JN.BasicBlockIR, TN.BasicBlockIR),
                  "bottleneck": (JN.BottleneckIRBlock, TN.BottleneckIRBlock)}[kind]
    jblock = jcls(depth=depth, stride=stride, se=se)
    x = rng.normal(0, 1, (2, 9, 9, cin)).astype(np.float32)
    variables = seeded_variables(_init_shapes(jblock, jnp.asarray(x)), seed=3)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    tblock = _port(tcls(cin, depth, stride, se), variables)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    # float32 convs in another summation order: observed max error ~1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(1.0, np.abs(want).max()))
    assert (tblock.shortcut_conv is None) == (shortcut == "slice")


@pytest.fixture(scope="module")
def faces():
    rng = np.random.default_rng(5)
    return rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["ir_18", "ir_se_18"])
def test_backbone_matches_flax(name, faces):
    jmodel = JN.build_model(name)
    variables = seeded_variables(_init_shapes(jmodel, jnp.asarray(faces)), seed=4)
    want_e, want_n = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(faces))
    tmodel = _port(TN.build_model(name, device="cpu"), variables)
    with torch.no_grad():
        got_e, got_n = tmodel(torch.from_numpy(faces).permute(0, 3, 1, 2))
    assert got_e.dtype == torch.float32 and tuple(got_e.shape) == (2, 512)
    # unit-norm embeddings: observed max error ~1e-6 (seeded weights)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got_e.numpy(), axis=1), 1.0, rtol=1e-5)


def _expected_entries(tree):
    """(state-dict key, shape) pairs of a flax shape tree by the port's
    naming rules, written out independently of utils/convert.py."""
    out = {}
    stats = tree.get("batch_stats", {})

    def walk(node, path, collection):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), collection)
                continue
            shape = tuple(v.shape)
            module = ".".join(path)
            if collection == "batch_stats":
                out[f"{module}.running_{k}"] = shape
                out[f"{module}.num_batches_tracked"] = ()
            elif k == "kernel":
                out[f"{module}.weight"] = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
            else:
                out[f"{module}.{ {'scale': 'weight'}.get(k, k)}"] = shape

    walk(tree["params"], (), "params")
    walk(stats, (), "batch_stats")
    return out


@pytest.mark.parametrize("name", sorted(TN.BUILD_TABLE))
def test_state_dict_names_and_shapes(name):
    shapes = _init_shapes(JN.build_model(name), jnp.zeros((1, 112, 112, 3), jnp.float32))
    with torch.device("meta"):
        layers, mode = TN.BUILD_TABLE[name]
        model = TN.IRBackbone(num_layers=layers, mode=mode)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _expected_entries(jax.tree_util.tree_map(lambda s: s, dict(shapes)))


def test_convert_round_trip_on_an_ir_tree():
    jmodel = JN.build_model("ir_se_18")
    variables = seeded_variables(_init_shapes(jmodel, jnp.zeros((1, 112, 112, 3))), seed=6)
    state = state_dict_from_flax(variables)
    model = TN.build_model("ir_se_18", device="cpu")
    model.load_state_dict(state)  # strict: every name and shape
    back = flax_from_state_dict(model.state_dict())
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], np.asarray(leaf))
    assert "alpha" in back["params"]["input_prelu"]
    assert back["params"]["fc"]["kernel"].shape == variables["params"]["fc"]["kernel"].shape
    assert set(back["batch_stats"]["features_bn"]) == {"mean", "var"}
    assert "features_bn" not in back["params"]
