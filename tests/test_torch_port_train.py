"""PyTorch port, the training slice against the JAX package, float32 on
the CPU: one train step of jabd_flagship (64x64, batch 2, 4 GT slots),
the optimizer and its schedule, the BatchNorm running statistics, the
weight init, the loader, checkpoints and `fit` across the freeze
boundary, and the TrainConfig copy.

The JAX side of the step is `jabd_tpu.train.make_train_step` itself, with
`matching_impl='pallas_interpret'` (the Pallas matching kernel in interpret
mode), run once: its TrainState carries an optimizer whose state records
the gradients it is given and whose update is zero, so one jitted call
yields the loss, the gradients and the new BatchNorm statistics. The
real optimizer (`jabd_tpu.train.make_optimizer`) is then held against the
port's on identical gradients, where the two agree to float32 rounding.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import losses as JL
from jabd_tpu import train as JT
from jabd_tpu.data import wider as JW
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.ops import anchors as JA
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.data import wider as TW
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models import layers as TLayers
from jabd_tpu_torch.models.init import reference_weights_init
from jabd_tpu_torch.utils.checkpoint import CheckpointManager
from jabd_tpu_torch.utils.convert import flax_from_state_dict, state_dict_from_flax
from tests.test_torch_port_model import seeded_variables

SIZE = 64
BATCH = 2


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _tree(x):
    """A flax FrozenDict / dict of arrays as nested dicts of numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(lambda a: a, dict(x)))


def _record_grads():
    """An optax transformation whose state is the last gradients it was
    given and whose updates are zero."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _synthetic_batch(seed, bsz=BATCH, g=4):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 50, (bsz, SIZE, SIZE, 3)).astype(np.float32)
    cxy = rng.uniform(0.25, 0.75, (bsz, g, 2))
    wh = rng.uniform(0.15, 0.45, (bsz, g, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    labels = rng.choice([1.0, -1.0], (bsz, g)).astype(np.float32)
    landms = (np.repeat(cxy, 5, axis=1).reshape(bsz, g, 10) + rng.normal(0, 0.02, (bsz, g, 10))).astype(
        np.float32
    )
    valid = np.ones((bsz, g), bool)
    valid[-1, -1] = False
    boxes[-1, -1] = 0.0
    return images, (boxes, labels, landms, valid)


@pytest.fixture(scope="module")
def step_pair():
    return run_step_pair()


def run_step_pair():
    """One JAX train step and one port train step from the same weights
    and batch."""
    cfg = dataclasses.replace(JC.get_model_config("jabd_flagship"), compute_dtype="float32")
    jtcfg = JC.TrainConfig(
        batch_size=BATCH, image_size=SIZE, max_targets=4, matching_impl="pallas_interpret"
    )
    model = jax_build_model(cfg, mode="train")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32),
    )
    variables = seeded_variables(shapes, seed=1)
    images, targets = _synthetic_batch(seed=2)
    anchors = JA.generate_anchors(cfg.anchors, (SIZE, SIZE)).copy()

    tx = _record_grads()
    state = JT.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        tx=tx,
    )
    new_state, jmetrics = JT.make_train_step(cfg, jtcfg)(
        state, jnp.asarray(images), JL.Targets(*(jnp.asarray(a) for a in targets)), jnp.asarray(anchors)
    )
    jax_out = {
        "metrics": {k: float(v) for k, v in jmetrics.items()},
        "grads": _tree(new_state.opt_state),
        "batch_stats": _tree(new_state.batch_stats),
    }

    tcfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    ttcfg = TC.TrainConfig(batch_size=BATCH, image_size=SIZE, max_targets=4)
    tmodel = build_model(tcfg, mode="train", device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(variables))
    tstate = TT.TrainState(
        model=tmodel,
        optimizer=TT.make_optimizer(tmodel.parameters(), 1e-3),
        lr=1e-3,
        steps_per_epoch=1,
        gamma=0.92,
    )
    tstate, tmetrics = TT.make_train_step(tcfg, ttcfg)(
        tstate,
        torch.from_numpy(images),
        TL.Targets(*(torch.from_numpy(a) for a in targets)),
        torch.from_numpy(anchors),
    )
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    port_out = {
        "metrics": {k: float(v) for k, v in tmetrics.items()},
        "grads": flax_from_state_dict({**grads, **{k: v for k, v in tmodel.state_dict().items() if "running" in k}})["params"],
        "batch_stats": flax_from_state_dict(tmodel.state_dict())["batch_stats"],
    }
    return variables, jax_out, port_out, tstate


def test_train_step_loss_matches_jax(step_pair):
    _, jax_out, port_out, tstate = step_pair
    assert tstate.step == 1 and tstate.count == 1
    for k, want in jax_out["metrics"].items():
        # observed relative error 3e-7; stated 1e-5
        np.testing.assert_allclose(port_out["metrics"][k], want, rtol=1e-5, err_msg=k)


def _grad_errors(got, want, floor=1e-5):
    """Per tensor |got - want| / |want| (Frobenius), over the tensors whose
    gradient is not ~0 (a bias before a BatchNorm has gradient 0 up to
    rounding), and the same over all tensors at once."""
    per = {p: float(np.linalg.norm(got[p] - w) / np.linalg.norm(w))
           for p, w in want.items() if np.linalg.norm(w) > floor}
    flat = lambda d: np.concatenate([d[p].ravel() for p in want])  # noqa: E731
    total = float(np.linalg.norm(flat(got) - flat(want)) / np.linalg.norm(flat(want)))
    return per, total


def test_train_step_gradients_match_jax(step_pair):
    """Float32 through ~60 layers and their backward: the JAX package's
    gradients lie 4.6e-3 (median per tensor; 1.6e-2 at worst, the ECA
    conv1d kernels) from the same step in float64, the port's 8e-5
    (2.8e-4 at worst), so the port is held to JAX within JAX's own
    float32 error, and to float64 far tighter."""
    variables, jax_out, port_out, _ = step_pair
    want = dict(_leaves(jax_out["grads"]))
    got = dict(_leaves(port_out["grads"]))
    assert got.keys() == want.keys()
    assert all(got[p].shape == w.shape for p, w in want.items())
    per, total = _grad_errors(got, want)
    assert len(per) > 0.9 * len(want)
    # observed: worst tensor 1.6e-2, all tensors 5e-3; stated 5e-2 and 2e-2
    assert max(per.values()) < 5e-2, max(per.items(), key=lambda kv: kv[1])
    assert total < 2e-2, total

    # The port in float64 on the same weights and batch.
    cfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model = build_model(cfg, mode="train", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    model.double()
    images, targets = _synthetic_batch(seed=2)
    anchors = JA.generate_anchors(cfg.anchors, (SIZE, SIZE)).astype(np.float64)
    out = tuple(o.double() for o in model(torch.from_numpy(images).double().permute(0, 3, 1, 2)))
    tg = TL.Targets(*(torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32 else a) for a in targets))
    TL.total_loss(TL.multibox_loss(out, torch.from_numpy(anchors), tg)).backward()
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    g64 = flax_from_state_dict({**{k: p.grad for k, p in model.named_parameters()}, **stats})["params"]
    per64, total64 = _grad_errors(got, dict(_leaves(g64)))
    # observed: worst tensor 2.8e-4; stated 2e-3
    assert max(per64.values()) < 2e-3, max(per64.items(), key=lambda kv: kv[1])
    assert total64 < 5e-4, total64


def test_batchnorm_statistics_match_flax_after_a_step(step_pair):
    """flax updates `var` with the biased batch variance; torch's own
    BatchNorm2d would use the unbiased one, x n / (n - 1). At 64x64 and
    batch 2 the stride-32 stage sees n = 2 * 2 * 2 = 8 values per
    channel: x 8/7, far outside the tolerance."""
    variables, jax_out, port_out, _ = step_pair
    want = dict(_leaves(jax_out["batch_stats"]))
    got = dict(_leaves(port_out["batch_stats"]))
    before = dict(_leaves(variables["batch_stats"]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        # observed: var 4.1e-5 relative (flax takes the variance as
        # E[x^2] - E[x]^2, which cancels), mean 1.9e-6 absolute near 0
        # (deep activations in float32); stated 1e-4 of the value + 1e-5
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-5, err_msg=str(path))
        assert not np.array_equal(w, before[path]), path
    assert ("backbone", "layer3_block4", "conv1", "bn", "var") in want


def test_batchnorm_module_running_var_is_biased(rng):
    import flax.linen as fnn

    x = rng.normal(0, 3, (2, 5, 1, 1)).astype(np.float32)  # n = 2 per channel
    bn = TLayers.BatchNorm2d(5).train()
    bn(torch.from_numpy(x))
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1)))
    _, upd = fbn.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    # observed max error 6e-8; stated 1e-6
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("freeze", [False, True])
def test_optimizer_matches_optax_on_identical_gradients(step_pair, freeze):
    """Two updates (steps_per_epoch 1, so the second at lr * gamma) from
    the same params and gradients: torch Adam(weight_decay) against the
    JAX package's optax chain, frozen backbone included."""
    variables, jax_out, _, _ = step_pair
    grads = jax_out["grads"]
    tx = JT.make_optimizer(1e-3, 1, gamma=0.92, weight_decay=5e-4, freeze_backbone=freeze)
    params = variables["params"]
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for scale in (1.0, -0.5):
        params, opt_state = update(params, opt_state, jax.tree_util.tree_map(lambda a: scale * a, grads))
    want = dict(_leaves(_tree(params)))

    cfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model = build_model(cfg, mode="train", device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    state = TT.TrainState(model, None, 0.0, steps_per_epoch=1, gamma=0.92)
    TT.new_phase(state, 1e-3, freeze, 5e-4)
    named = dict(model.named_parameters())
    gsd = state_dict_from_flax({"params": grads, "batch_stats": variables["batch_stats"]})
    for scale in (1.0, -0.5):
        for k, p in named.items():
            p.grad = None if not p.requires_grad else scale * gsd[k].clone()
        state.apply_gradients()
    got = dict(_leaves(flax_from_state_dict(model.state_dict())["params"]))
    init = dict(_leaves(variables["params"]))
    for path, w in want.items():
        # observed max error 1.2e-7 on updates of ~2e-3; stated 1e-6
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-6, err_msg=str(path))
        if freeze and path[0] == "backbone":
            np.testing.assert_array_equal(got[path], init[path])


def test_schedule_matches_optax_exponential_decay():
    steps_per_epoch, gamma = 7, 0.92
    sched = optax.exponential_decay(1e-3, steps_per_epoch, gamma, staircase=True)
    for count in range(3 * steps_per_epoch):
        # optax computes in float32
        assert math.isclose(TT.step_lr(1e-3, steps_per_epoch, gamma, count), float(sched(count)), rel_tol=1e-6)
    assert TT.step_lr(1e-3, 7, gamma, 6) == 1e-3 and TT.step_lr(1e-3, 7, gamma, 7) == 1e-3 * gamma


def test_reference_weights_init_statistics():
    cfg = TC.get_model_config("jabd_flagship")
    model = build_model(cfg, mode="train", device="cpu")
    reference_weights_init(model, torch.Generator().manual_seed(0))
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    w = torch.cat([m.weight.flatten() for m in convs]).detach()
    assert abs(float(w.mean())) < 1e-3 and abs(float(w.std()) - 0.02) < 5e-4
    for m in convs:
        if m.bias is not None:
            bound = 1 / math.sqrt(m.weight[0].numel())
            assert float(m.bias.abs().max()) <= bound
    scale = torch.cat([m.weight for m in bns]).detach()
    assert abs(float(scale.mean()) - 1) < 2e-3 and abs(float(scale.std()) - 0.02) < 2e-3
    assert all(float(m.bias.abs().max()) == 0 for m in bns)
    assert float(model.fpn.nlm.W.weight.abs().sum()) > 0  # re-drawn like any conv
    # The same parameters as the JAX package's init re-draws: every conv
    # kernel (ndim >= 3, ECA conv1d included).
    shapes = jax.eval_shape(
        functools.partial(jax_build_model(JC.get_model_config("jabd_flagship")).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
    )["params"]
    kernels = [v for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]
               if p[-1].key == "kernel" and v.ndim >= 3]
    assert sum(math.prod(v.shape) for v in kernels) == w.numel()
    # Other init types and 'none'.
    before = {k: v.clone() for k, v in model.state_dict().items()}
    reference_weights_init(model, torch.Generator().manual_seed(0), "none")
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    for kind in ("xavier", "kaiming", "orthogonal"):
        reference_weights_init(model, torch.Generator().manual_seed(1), kind)
    with pytest.raises(NotImplementedError):
        reference_weights_init(model, torch.Generator(), "uniform")


class _Dataset:
    """In-memory duck-typed dataset: `get(idx, rng)` draws a noise image
    and 0-3 boxes from the sample's stream (no box: backfilled)."""

    def __init__(self, n, size=SIZE):
        self.n = n
        self.size = size

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        image = rng.normal(0, 50, (self.size, self.size, 3)).astype(np.float32)
        k = int(rng.integers(0, 4)) if idx % 3 else 1 + idx % 2
        cxy = rng.uniform(0.3, 0.7, (k, 2))
        wh = rng.uniform(0.2, 0.4, (k, 2))
        t = np.zeros((k, 15), np.float32)
        t[:, :2] = cxy - wh / 2
        t[:, 2:4] = cxy + wh / 2
        t[:, 4:14] = np.repeat(cxy, 5, axis=0).reshape(k, 10)
        t[:, 14] = 1.0
        return image, t


def test_train_loader_equals_jax(tmp_path):
    ds = _Dataset(11, size=8)
    got = list(TW.train_loader(ds, 3, max_targets=5, seed=4, num_workers=2))
    want = list(JW.train_loader(ds, 3, max_targets=5, seed=4, num_workers=2))
    assert len(got) == len(want) == 3
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a, b)
    label = tmp_path / "label.txt"
    label.write_text("# a.jpg\n1 2 3 4 5 6 0 7 8 0 9 10 0 11 12 0 13 14 0 0.9\n# b.jpg\n"
                     "1 1 2 2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1\n")
    gp, ga = TW.parse_wider_labels(str(label))
    wp, wa = JW.parse_wider_labels(str(label))
    assert gp == wp
    for a, b in zip(ga, wa):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip_and_max_to_keep(tmp_path):
    cfg = dataclasses.replace(TC.get_model_config("mnet_v3_plain"), compute_dtype="float32")
    tcfg = TC.TrainConfig(batch_size=2, image_size=SIZE, max_targets=4)
    state = TT.create_train_state(cfg, tcfg, 1, device="cpu")
    images, targets = _synthetic_batch(seed=5)
    anchors = torch.from_numpy(JA.generate_anchors(JC.get_model_config("mnet_v3_plain").anchors, (SIZE, SIZE)).copy())
    step = TT.make_train_step(cfg, tcfg)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in range(1, 4):
        state, _ = step(state, torch.from_numpy(images), TL.Targets(*(torch.from_numpy(a) for a in targets)), anchors)
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    fresh = TT.create_train_state(cfg, dataclasses.replace(tcfg, seed=9), 1, device="cpu")
    restored = mgr.restore(fresh)
    assert restored.step == 3 and restored.count == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)
    assert CheckpointManager(str(tmp_path / "empty")).restore(fresh) is None


def test_fit_resumes_at_the_freeze_boundary(tmp_path):
    """Two epochs across the freeze boundary, the second one resumed from
    the checkpoint the last freeze epoch wrote: the restore template is
    built frozen, the unfreeze phase starts a FRESH optimizer at
    lr_unfreeze (schedule count 0), and the backbone trains again."""
    cfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    ds = _Dataset(4)
    tcfg = TC.TrainConfig(
        batch_size=2, image_size=SIZE, freeze_epochs=1, total_epochs=1, max_targets=4, save_period=1
    )
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    init = TT.create_train_state(cfg, tcfg, 2, device="cpu")
    backbone0 = {k: v.clone() for k, v in init.model.backbone.state_dict().items()}
    state = TT.fit(cfg, tcfg, ds, log_dir=str(tmp_path / "logs"), checkpoint_manager=mgr, device="cpu")
    assert mgr.latest_step() == 1 and state.step == 2
    # The frozen backbone: parameters unchanged, BatchNorm statistics moved.
    after = state.model.backbone.state_dict()
    for k, v in backbone0.items():
        if k.endswith(("weight", "bias")):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["stem.bn.running_mean"], backbone0["stem.bn.running_mean"])

    tcfg2 = dataclasses.replace(tcfg, total_epochs=2)
    state2 = TT.fit(cfg, tcfg2, ds, log_dir=str(tmp_path / "logs2"), checkpoint_manager=mgr, device="cpu")
    assert mgr.latest_step() == 2 and state2.step == 4 and state2.count == 2
    assert state2.lr == tcfg2.lr_unfreeze
    assert all(p.requires_grad for p in state2.model.parameters())
    assert any(not torch.equal(state2.model.backbone.state_dict()[k], after[k]) for k in backbone0 if k.endswith("weight"))
    rows = (tmp_path / "logs2" / "metrics.csv").read_text().splitlines()
    assert rows[0] == "epoch,step,loss,loss_l,loss_c,loss_landm,lr" and len(rows) == 2
    epoch, step, loss, *_, lr = rows[1].split(",")
    assert (int(epoch), int(step)) == (2, 4) and np.isfinite(float(loss))
    assert abs(float(lr) - tcfg2.lr_unfreeze) < 1e-12  # gamma^0: a fresh schedule
    first = (tmp_path / "logs" / "metrics.csv").read_text().splitlines()[1].split(",")
    assert abs(float(first[-1]) - tcfg.lr_freeze) < 1e-12
    history = list((tmp_path / "logs").glob("loss_*/epoch_loss.txt"))
    assert len(history) == 1 and len(history[0].read_text().split()) == 1


def test_unported_train_options_raise():
    """No TrainConfig option raises any more: fsdp, remat, microbatches and
    device_augment build their steps, alone and combined; on one process
    fsdp is the plain path (the JAX package's fit shards only over a mesh
    of more than one device; tests/test_torch_port_parallel_fsdp.py holds
    it over two ranks). Only a model with an IoU head raises."""
    cfg = TC.get_model_config("jabd_flagship")
    for kw in ({"fsdp": True}, {"fsdp": True, "remat": True}, {"microbatches": 2}, {"remat": True},
               {"device_augment": True}, {"microbatches": 2, "remat": True, "device_augment": True}):
        assert callable(TT.make_train_step(cfg, TC.TrainConfig(**kw)))
    state = TT.create_train_state(cfg, TC.TrainConfig(fsdp=True), 1, device="cpu")
    assert not any(hasattr(p, "full_tensor") for p in state.model.parameters())
    with pytest.raises(ValueError, match="IoU head"):
        TT.make_train_step(TC.get_model_config("re50_iou_head"), TC.TrainConfig())


def test_train_config_is_a_faithful_copy():
    assert repr(TC.TrainConfig()) == repr(JC.TrainConfig())


def test_convert_round_trip(step_pair):
    variables = step_pair[0]
    back = flax_from_state_dict(state_dict_from_flax(variables))
    want = dict(_leaves(variables["params"]))
    got = dict(_leaves(back["params"]))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert dict(_leaves(back["batch_stats"])).keys() == dict(_leaves(variables["batch_stats"])).keys()
