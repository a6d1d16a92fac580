"""PyTorch port, `TrainConfig.remat` on the CPU at float32: jabd_flagship,
64x64, batch 2. The checkpointed step against the port's plain step (bit
for bit, the BatchNorm running statistics included: the recompute must not
update them a second time) and against the JAX package's remat step
(`jax.checkpoint` around the forward, Pallas matching in interpret
mode)."""

import numpy as np
import pytest
import torch

from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.init import reference_weights_init
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_train import _synthetic_batch

SIZE = 64
KW = dict(batch_size=2, image_size=SIZE, max_targets=4)


@pytest.fixture(scope="module")
def setup():
    variables = S.variables_for(SIZE)
    images, targets = _synthetic_batch(seed=2)
    return variables, images, targets, S.anchors_for(SIZE)


def test_remat_step_is_the_plain_step_bit_for_bit(setup):
    variables, images, targets, anchors = setup
    x = (torch.from_numpy(images),)
    plain = S.port_step(KW, variables, x, targets, anchors)
    remat = S.port_step(dict(KW, remat=True), variables, x, targets, anchors)
    S.assert_ports_identical(remat, plain)
    # and the statistics did move, once: (1 - m) * before + m * batch
    before = dict(S._leaves(variables["batch_stats"]))
    assert all(not np.array_equal(v, before[k]) for k, v in remat["batch_stats"].items())


def test_remat_batchnorm_updates_once_over_steps():
    """Three remat steps against three plain steps from the reference's
    init: every buffer (running mean, running var, num_batches_tracked)
    bit-identical after each step."""
    cfg = S.model_cfgs()[1]
    images, targets = _synthetic_batch(seed=3)
    anchors = torch.from_numpy(S.anchors_for(SIZE))
    from jabd_tpu_torch import losses as TL

    tg = TL.Targets(*(torch.from_numpy(a) for a in targets))
    states = []
    for remat in (False, True):
        model = build_model(cfg, mode="train", device="cpu")
        reference_weights_init(model, torch.Generator().manual_seed(0))
        states.append((TT.TrainState(model, TT.make_optimizer(model.parameters(), 1e-3), 1e-3, 1, 0.92),
                       TT.make_train_step(cfg, TC.TrainConfig(**KW, remat=remat))))
    for _ in range(3):
        metrics = [step(state, torch.from_numpy(images), tg, anchors)[1] for state, step in states]
        assert float(metrics[0]["loss"]) == float(metrics[1]["loss"])
        bufs = [dict(state.model.named_buffers()) for state, _ in states]
        for k, v in bufs[0].items():
            assert torch.equal(v, bufs[1][k]), k
    assert int(bufs[1]["backbone.stem.bn.num_batches_tracked"]) == 3


def test_remat_step_matches_jax_remat(setup):
    variables, images, targets, anchors = setup
    want = S.jax_step(dict(KW, remat=True, matching_impl="pallas_interpret"), variables, (images,), targets, anchors)
    got = S.port_step(dict(KW, remat=True), variables, (torch.from_numpy(images),), targets, anchors)
    S.assert_port_matches_jax(got, want)
