"""PyTorch port, `TrainConfig.microbatches` (ghost BatchNorm) on the CPU at
float32: jabd_flagship, 64x64, batch 4 in two chunks of 2. The port's
step against the JAX package's microbatched step (`lax.scan` over chunks,
Pallas matching in interpret mode); the duplicated-halves invariant of
tests/test_train.py; remat combined with microbatches."""

import dataclasses

import numpy as np
import pytest
import torch

from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.init import reference_weights_init
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_train import _synthetic_batch

SIZE = 64
KW = dict(batch_size=4, image_size=SIZE, max_targets=4, microbatches=2)


@pytest.fixture(scope="module")
def setup():
    variables = S.variables_for(SIZE)
    images, targets = _synthetic_batch(seed=6, bsz=4)
    return variables, images, targets, S.anchors_for(SIZE)


def test_microbatched_step_matches_jax(setup):
    variables, images, targets, anchors = setup
    want = S.jax_step(dict(KW, matching_impl="pallas_interpret"), variables, (images,), targets, anchors)
    got = S.port_step(KW, variables, (torch.from_numpy(images),), targets, anchors)
    S.assert_port_matches_jax(got, want)
    # Not the whole-batch step: ghost BN moves the statistics twice.
    whole = S.port_step(dict(KW, microbatches=1), variables, (torch.from_numpy(images),), targets, anchors)
    assert whole["metrics"]["loss"] != got["metrics"]["loss"]


def test_remat_with_microbatches_is_bit_for_bit(setup):
    variables, images, targets, anchors = setup
    x = (torch.from_numpy(images),)
    S.assert_ports_identical(
        S.port_step(dict(KW, remat=True), variables, x, targets, anchors),
        S.port_step(KW, variables, x, targets, anchors),
    )


def test_microbatched_step_matches_full_batch_on_duplicated_halves():
    """A batch whose two halves are identical: two chunks give the loss
    and the averaged gradients of the whole batch (equal ghost-BN
    statistics, equal positive counts); the running statistics move twice,
    0.81 * old + 0.19 * s against 0.9 * old + 0.1 * s. In float64, where
    the invariant is exact up to rounding (float32 leaves 9e-5)."""
    cfg = S.model_cfgs()[1]
    half_images, half_targets = _synthetic_batch(seed=8)
    images = torch.from_numpy(np.concatenate([half_images, half_images])).double()
    targets = TL.Targets(*(torch.from_numpy(np.concatenate([a, a])) for a in half_targets))
    targets = targets._replace(boxes=targets.boxes.double(), labels=targets.labels.double(),
                               landms=targets.landms.double())
    anchors = torch.from_numpy(S.anchors_for(SIZE)).double()
    out = {}
    for mb in (1, 2):
        model = build_model(cfg, mode="train", device="cpu")
        reference_weights_init(model, torch.Generator().manual_seed(0))
        model.double()
        before = {k: v.clone() for k, v in model.named_buffers()}
        state = TT.TrainState(model, TT.make_optimizer(model.parameters(), 1e-3), 1e-3, 1, 0.92)
        _, metrics = TT.make_train_step(cfg, TC.TrainConfig(**dict(KW, microbatches=mb)))(state, images, targets, anchors)
        out[mb] = (metrics, {k: p.grad.clone() for k, p in model.named_parameters()}, dict(model.named_buffers()))
    for k in out[1][0]:
        # observed equal; stated 1e-12 relative
        np.testing.assert_allclose(float(out[2][0][k]), float(out[1][0][k]), rtol=1e-12, err_msg=k)
    g1 = torch.cat([g.flatten() for g in out[1][1].values()])
    g2 = torch.cat([g.flatten() for g in out[2][1].values()])
    # observed 1.5e-13 relative over all gradients; stated 1e-10
    assert float((g2 - g1).norm() / g1.norm()) < 1e-10
    for k in ("backbone.stem.bn.running_mean", "fpn.output1.bn.running_var"):
        old, one = before[k], out[1][2][k]
        s = (one - 0.9 * old) / 0.1
        torch.testing.assert_close(out[2][2][k], 0.81 * old + 0.19 * s, rtol=1e-9, atol=1e-12)


def test_microbatches_must_divide_the_batch(setup):
    variables, images, targets, anchors = setup
    with pytest.raises(ValueError, match="not divisible"):
        S.port_step(dict(KW, microbatches=3), variables, (torch.from_numpy(images),), targets, anchors)


def test_microbatch_config_is_the_jax_one():
    from jabd_tpu import configs as JC

    for kw in ({"microbatches": 2}, {"remat": True}, {"device_augment": True, "augment_bucket": (96, 96)}):
        assert repr(dataclasses.replace(TC.TrainConfig(), **kw)) == repr(dataclasses.replace(JC.TrainConfig(), **kw))
