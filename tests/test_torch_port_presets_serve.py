"""PyTorch port, the presets slice's serving weights against the JAX
package at float32 on the CPU, for a preset of each family, ResNet
3-level (re50_eca_nonlocal), ResNet 4-level (re152_4level), EPSANet
(epsa50_4level) and MobileNetV3 4-level (mnet_v3_4level):
`fold_batchnorm` and the `Predictor` against the unfolded graph and the
JAX Predictor (EPSA's bn2 left in place), the npz round trip in both
directions, and the reference's weight init on the new modules.

Backbones run one block per stage (tests/test_torch_port_resnet.py's
`shallow`), at the published widths, 64x64, batch 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import predict as JP
from jabd_tpu.utils import np_ckpt as JNP
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import predict as TP
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.fold import fold_batchnorm
from jabd_tpu_torch.utils import np_ckpt as TNP
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_model import to_nchw
from tests.test_torch_port_presets import FAMILIES
from tests.test_torch_port_resnet import preset_pair, shallow

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def shallow_backbones():
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        yield


@pytest.mark.parametrize("preset", FAMILIES)
def test_folded_predictor_matches_unfolded_and_jax(preset):
    """fold_batchnorm folds every BatchNorm that follows a conv and leaves
    EPSA's bn2 in place; the folded Predictor's detections equal the
    unfolded one's and the JAX Predictor's (XLA NMS)."""
    jmodel, variables, tmodel = preset_pair(preset, (SIZE, SIZE), seed=5)
    tcfg = tmodel.cfg
    folded = build_model(tcfg, mode="eval", device="cpu")
    folded.load_state_dict(tmodel.state_dict())
    fold_batchnorm(folded.eval())
    left = [n for n, m in folded.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if preset == "epsa50_4level":
        assert left and all(n.endswith(".bn2") for n in left) and len(left) == 5
    else:
        assert left == []
    x = np.random.default_rng(9).normal(0, 50, (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ref, got = tmodel(to_nchw(x)), folded(to_nchw(x))
    for r, g in zip(ref, got):
        # observed max error 2.9e-5 on heads up to 1.2e1; stated 3e-5 * max(1, max|ref|)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=3e-5 * max(1.0, float(r.abs().max())), rtol=0)

    kw = dict(confidence=0.02, input_shape=(SIZE, SIZE))
    state = state_dict_from_flax(variables)
    tpred = TP.Predictor(tcfg, state, TC.PredictConfig(**kw), device="cpu")
    upred = TP.Predictor(tcfg, state, TC.PredictConfig(**kw), fold_bn=False, device="cpu")
    jcfg = dataclasses.replace(JC.get_model_config(preset), compute_dtype="float32")
    jpred = JP.Predictor(jcfg, variables, JC.PredictConfig(**kw), use_pallas=False)
    td, tv = tpred.detect_preprocessed(x)
    ud, uv = upred.detect_preprocessed(x)
    jd, jv = jpred.detect_preprocessed(x)
    assert int(tv.sum()) > 0
    for d, v in ((ud.numpy(), uv.numpy()), (np.asarray(jd), np.asarray(jv))):
        np.testing.assert_array_equal(tv.numpy(), v)
        # observed max error 3.9e-6 in normalized coordinates; stated 1e-5
        np.testing.assert_allclose(td.numpy(), d, atol=1e-5, rtol=0)


@pytest.mark.parametrize("preset", FAMILIES)
def test_npz_round_trip(tmp_path, preset):
    """A JAX-written npz loads in the port (grouped kernels, merge_shared,
    EPSA's bn2 with its statistics), and the port's file loads back in JAX,
    array for array."""
    _, variables, tmodel = preset_pair(preset, (SIZE, SIZE), seed=6)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JNP.save_variables_npz(jax_path, variables)
    state = TNP.load_variables_npz(jax_path, tmodel.state_dict())
    want = state_dict_from_flax(variables)
    assert state.keys() == tmodel.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    TNP.save_variables_npz(port_path, state)
    got = JNP.flatten_tree(JNP.load_variables_npz(port_path, variables))
    for k, v in JNP.flatten_tree(variables).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize(
    "preset,path",
    [("epsa50_4level", "backbone.layer2_block0"), ("jabd_pixelshuffle", "fpn.pix"),
     ("re50_iou_head", "iou_head1")],
)
def test_weights_init_reaches_the_new_modules(preset, path):
    """The reference's from-scratch init redraws the same leaves of a new
    module in both packages (an EPSABlock: grouped PSA convs, SEWeight's
    biased convs, the bare bn2; the pix conv; an IoU head), with the JAX
    package's fans: a grouped conv's fan_in is k*k*C/g, its bias bound
    1/sqrt(fan_in)."""
    import jax

    from jabd_tpu.models.init import reference_weights_init as jax_init
    from jabd_tpu_torch.models.init import reference_weights_init
    from jabd_tpu_torch.utils.convert import flax_from_state_dict
    from tests.test_torch_port_train import _leaves

    _, variables, tmodel = preset_pair(preset, (SIZE, SIZE), seed=7)
    tree, module = variables["params"], tmodel
    for part in path.split("."):
        tree, module = tree[part], getattr(module, part)
    before = dict(_leaves(tree))
    jax_after = dict(_leaves(jax.tree_util.tree_map(np.asarray, jax.jit(jax_init)(jax.random.PRNGKey(0), tree))))
    reference_weights_init(module, torch.Generator().manual_seed(0))
    port_after = dict(_leaves(flax_from_state_dict(module.state_dict())["params"]))
    assert port_after.keys() == jax_after.keys() == before.keys()
    changed = {k for k in before if not np.array_equal(jax_after[k], before[k])}
    assert changed == {k for k in before if not np.array_equal(port_after[k], before[k])}
    assert len(changed) == len(before)  # every conv and BatchNorm leaf
    for k, v in port_after.items():
        if k[-1] == "bias" and k[:-1] + ("kernel",) in port_after:  # a conv bias
            bound = float(np.prod(port_after[k[:-1] + ("kernel",)].shape[:-1])) ** -0.5
            assert np.abs(v).max() <= bound and np.abs(jax_after[k]).max() <= bound, k
    if preset == "epsa50_4level":
        k = ("psa", "conv_4", "kernel")  # 9x9, groups 16
        assert port_after[k].shape == jax_after[k].shape == (9, 9, 128 // 16, 32)
        assert ("bn2", "scale") in changed
