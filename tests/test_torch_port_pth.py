"""PyTorch port, the reference's `.pth` names (utils/torch_convert.py),
against the JAX package's converter on the same seeded weights:

- for each backbone family the port's `export_state_dict_auto` of the
  port's state dict gives the JAX package's export of the same variables:
  the same keys and bit-equal values and dtypes;
- the port's `convert_state_dict_auto` of that dict gives
  `state_dict_from_flax` of the variables, bit for bit, and so does the
  JAX converter composed with it;
- the mnet025 backbone-only `stage1...` prefix rule, the refusal of folded
  state dicts, and `save_pth` / `load_pth` (the `state_dict` wrapper,
  `module.` prefixes) across the two packages.

ResNet and EPSANet specs are cut to one block per stage
(`test_torch_port_resnet.py::shallow`); the walks read the tables when
they run, so the cut reaches both packages' converters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.utils import torch_convert as JTC
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.utils import torch_convert as TTC
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables
from tests.test_torch_port_resnet import shallow

# One preset per walk and wiring: MobileNetV1-0.25; the flagship's 3- and
# 4-stage MobileNetV3 splits, its pixel-shuffle FPN and eca_g blocks;
# ResNet-50 (NLM `Nlm`, tap ECAs), ResNet-152's 4-level shared merge and
# shared ssh, ResNet-50 `_self`, the IoU head; EPSANet-50.
PRESETS = (
    "retinaface_mnet025", "jabd_flagship", "mnet_v3_4level", "jabd_pixelshuffle", "jabd_ecablock_g",
    "re50_eca_nonlocal", "re152_4level", "re50_self_4level", "re50_iou_head", "epsa50_4level",
)


@pytest.fixture(scope="module", autouse=True)
def shallow_backbones():
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        yield


def _variables(preset, seed=4):
    model = jax_build_model(JC.get_model_config(preset), mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)
    )
    return seeded_variables(shapes, seed=seed)


def _assert_same_dict(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_state(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("preset", PRESETS)
def test_export_matches_jax(preset):
    variables = _variables(preset)
    want = JTC.export_state_dict_auto(variables, JC.get_model_config(preset))
    got = TTC.export_state_dict_auto(state_dict_from_flax(variables), TC.get_model_config(preset))
    _assert_same_dict(got, want)
    assert any(k.endswith("num_batches_tracked") for k in got)


@pytest.mark.parametrize("preset", PRESETS)
def test_convert_matches_jax(preset):
    """Reference names -> the port's state dict: the variables themselves,
    and the JAX converter's trees through state_dict_from_flax; every key
    of the port's model is there."""
    variables = _variables(preset, seed=5)
    sd = JTC.export_state_dict_auto(variables, JC.get_model_config(preset))
    got = TTC.convert_state_dict_auto(sd, TC.get_model_config(preset))
    _assert_same_state(got, state_dict_from_flax(variables))
    params, stats = JTC.convert_state_dict_auto(sd, JC.get_model_config(preset))
    _assert_same_state(got, state_dict_from_flax({"params": params, "batch_stats": stats}))
    model = build_model(TC.get_model_config(preset), mode="eval", device="cpu")
    model.load_state_dict(got)  # strict: the port's every key


def test_mnet025_backbone_only_prefix():
    """A backbone-only pretrain dict ('stage1...' without 'body.') converts
    to the backbone's entries, as the JAX converter converts it."""
    preset = "retinaface_mnet025"
    sd = JTC.export_state_dict_auto(_variables(preset), JC.get_model_config(preset))
    bare = {k[len("body."):]: v for k, v in sd.items() if k.startswith("body.")}
    assert all(k.startswith("stage") for k in bare)
    got = TTC.convert_state_dict_auto(bare, TC.get_model_config(preset))
    params, stats = JTC.convert_state_dict_auto(bare, JC.get_model_config(preset))
    _assert_same_state(got, state_dict_from_flax({"params": params, "batch_stats": stats}))
    assert got and all(k.startswith("backbone.") for k in got)


def test_export_refuses_a_folded_state_dict():
    preset = "jabd_flagship"
    model = build_model(TC.get_model_config(preset), mode="eval", device="cpu")
    model.load_state_dict(state_dict_from_flax(_variables(preset)))
    with pytest.raises(ValueError, match="BN-folded"):
        TTC.export_state_dict_auto(fold_batchnorm(model.eval()).state_dict(), TC.get_model_config(preset))


def test_save_and_load_pth_across_packages(tmp_path):
    preset = "jabd_flagship"
    sd = TTC.export_state_dict_auto(state_dict_from_flax(_variables(preset)), TC.get_model_config(preset))
    path = str(tmp_path / "m.pth")
    TTC.save_pth(sd, path)
    _assert_same_dict(TTC.load_pth(path), sd)
    _assert_same_dict(JTC.load_pth(path), sd)
    # A DataParallel checkpoint in a {"state_dict": ...} wrapper.
    wrapped = str(tmp_path / "w.tar")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, wrapped)
    _assert_same_dict(TTC.load_pth(wrapped), sd)
    JTC.save_pth(sd, str(tmp_path / "j.pth"))
    _assert_same_dict(TTC.load_pth(str(tmp_path / "j.pth")), sd)
