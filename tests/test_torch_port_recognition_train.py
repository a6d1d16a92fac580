"""PyTorch port, the recognition training step and `fit`
(recognition/train.py) and `recognition.cli train` against the JAX
package, on the CPU in float32, from the same weights (the JAX
`RecTrainState`'s, carried by `utils/convert.rec_state_dicts_from_flax`)
and the same numpy-seeded batches; ir_18 at 56x56 with dropout 0 on both
sides, as the JAX package's own step tests run it:

- the weight-decay partition agrees name for name; the lr of every step of
  a 12-step run agrees with the JAX optimizer's schedule for several hints
  and milestones; milestones that do not increase strictly raise (the JAX
  package scales them into collisions for hints <= 4 and drops decays);
- `features_bn`'s running variance after a train-mode forward is flax's
  (the biased batch variance, not torch's unbiased one);
- two train steps with AdaFace, ArcFace and CosFace: loss, acc, every
  parameter, the BatchNorm statistics and AdaFace's EMA; the
  device-augmented step against JAX's; microbatches=2 on duplicated halves
  against one batch (the JAX package's own bound); a bf16 step;
- dropout (which the JAX comparisons leave at 0): its mask keeps 1 - p and
  scales by 1 / (1 - p) in float32 and under bf16 autocast, and a step
  with it lands on the float64 step with the same mask;
- `fit`: checkpoints, resume, the best copy and metrics.csv, as
  tests/test_recognition.py::test_fit_checkpoints_resume_best_metrics;
  `cli train --device cpu` (host and device loaders), its checkpoint read
  by `cli verify --ckpt`, and its refusals.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from jabd_tpu.recognition import device_augment as JFDA
from jabd_tpu.recognition import heads as JH
from jabd_tpu.recognition import net as JN
from jabd_tpu.recognition import train as JRT
from jabd_tpu_torch.recognition import cli as RC
from jabd_tpu_torch.recognition import data as D
from jabd_tpu_torch.recognition import device_augment as FDA
from jabd_tpu_torch.recognition import heads as TH
from jabd_tpu_torch.recognition import net as TN
from jabd_tpu_torch.recognition import train as RT
from jabd_tpu_torch.utils.convert import flax_from_rec_state_dicts, rec_state_dicts_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_recognition_device_augment import _rand_face

SIZE, B, CLASSES, LR = 56, 4, 8, 0.1


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32), rng.integers(0, CLASSES, n).astype(np.int32)


def _jax_state(head_type):
    model = JN.IRBackbone(num_layers=18, mode="ir", dropout=0.0)
    head = JH.build_head(head_type, class_num=CLASSES)
    state = JRT.create_state(jax.random.PRNGKey(0), model, head, num_train_steps_hint=100, lr=LR,
                             milestones=(50,), image_size=SIZE)
    return model, head, state


def _port_state(jstate, head_type, lr=LR):
    model_sd, head_sd = rec_state_dicts_from_flax(jstate.params, jstate.batch_stats)
    model = TN.IRBackbone(num_layers=18, mode="ir", dropout=0.0, image_size=SIZE)
    model.load_state_dict(model_sd)
    head = TH.build_head(head_type, class_num=CLASSES, device="cpu")
    head.load_state_dict(head_sd)
    return RT.create_state(model, head, num_train_steps_hint=100, lr=lr, milestones=(50,))


def _port_tree(state):
    return flax_from_rec_state_dicts(state.model.state_dict(), state.head.state_dict())


def test_decay_partition_agrees_name_for_name():
    model, head, jstate = _jax_state("adaface")
    mask = jax.tree_util.tree_map_with_path(lambda path, _: not JRT._is_bn_param(path), jstate.params)
    state = _port_state(jstate, "adaface")
    decayed = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    assert state.optimizer.param_groups[0]["weight_decay"] == 5e-4
    assert state.optimizer.param_groups[1]["weight_decay"] == 0.0
    flags = {n: torch.full_like(p, float(id(p) in decayed)) for n, p in state.model.named_parameters()}
    flags.update({n: b for n, b in state.model.state_dict().items() if "running" in n or "num_batches" in n})
    params, _ = flax_from_rec_state_dicts(flags, {"kernel": torch.ones(1)})
    want = dict(_leaves(mask))
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert np.all(got[path] == float(bool(w))), path
    assert sum(bool(w) for w in want.values()) > 0 and not all(bool(w) for w in want.values())
    assert want[("head", "kernel")] and RT._is_bn_param("model.stage1_block0.bn0.weight")
    assert not RT._is_bn_param("model.stage1_block0.prelu.alpha") and not RT._is_bn_param("model.fc.bias")


class _Tiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(2)(x.reshape(x.shape[0], -1))


@pytest.mark.parametrize("hint,milestones", [(5, None), (26, None), (100, None), (12, (3, 7, 9)), (12, (0, 4))])
def test_lr_of_every_step_matches_the_jax_schedule(hint, milestones):
    """The JAX optimizer's lr of step k, read off its update on a
    no-decay leaf (grad 1: the momentum trace t_k = 0.9 t_{k-1} + 1, update
    -lr_k t_k), against the port's group lr of the same step."""
    jstate = JRT.create_state(jax.random.PRNGKey(0), _Tiny(), JH.build_head("cosface", class_num=2), hint,
                              lr=0.1, milestones=milestones, image_size=2)
    params = {"bn": {"w": jnp.zeros(())}}
    opt = jstate.tx.init(params)
    port = RT.create_state(torch.nn.BatchNorm1d(1), TH.build_head("cosface", class_num=2, device="cpu"), hint,
                           lr=0.1, milestones=milestones)
    t = 0.0
    for k in range(12):
        updates, opt = jstate.tx.update({"bn": {"w": jnp.ones(())}}, opt, params)
        t = 0.9 * t + 1.0
        want = -float(updates["bn"]["w"]) / t
        port.optimizer.zero_grad()
        port.apply_gradients()
        got = port.optimizer.param_groups[0]["lr"]
        assert got == pytest.approx(want, rel=1e-6), (k, got, want)
        assert got == pytest.approx(float(optax.piecewise_constant_schedule(
            0.1, {m: 0.1 for m in port.milestones})(k)), rel=1e-6)
    assert port.step == 12


@pytest.mark.parametrize("hint,milestones", [(4, None), (3, None), (1, None), (12, (5, 5)), (12, (7, 3))])
def test_colliding_milestones_raise(hint, milestones):
    """ADVICE #1: scaled to a hint <= 4, the recipe's 12 / 20 / 24 of 26
    collide (hint 4: 1, 3, 3) and the JAX schedule, a dict, keeps one of
    them: its lr ends 100x down instead of 1000x. The port raises."""
    with pytest.raises(ValueError, match="increase strictly"):
        RT.create_state(torch.nn.Linear(1, 1), TH.build_head("cosface", class_num=2, device="cpu"), hint,
                        lr=0.1, milestones=milestones)
    if hint == 4:
        jstate = JRT.create_state(jax.random.PRNGKey(0), _Tiny(), JH.build_head("cosface", class_num=2), hint,
                                  lr=0.1, image_size=2)
        opt = jstate.tx.init({"bn": {"w": jnp.zeros(())}})
        for _ in range(5):
            updates, opt = jstate.tx.update({"bn": {"w": jnp.ones(())}}, opt, {"bn": {"w": jnp.zeros(())}})
        trace = sum(0.9 ** i for i in range(5))
        assert -float(updates["bn"]["w"]) / trace == pytest.approx(0.1 * 0.1 ** 2, rel=1e-5)  # not 0.1 ** 3


def test_features_bn_running_var_is_flax_biased():
    """Fails on the tree before the repair: nn.BatchNorm1d folded the
    unbiased batch variance (x B / (B - 1), 4/3 at B = 4) into running_var."""
    jmodel = JN.IRBackbone(num_layers=18, mode="ir", dropout=0.0)
    x, _ = _batch(3)
    variables = jax.jit(functools.partial(jmodel.init, train=False))(jax.random.PRNGKey(1), jnp.asarray(x))
    _, mut = jax.jit(lambda v, i: jmodel.apply(v, i, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model_sd, _ = rec_state_dicts_from_flax({"model": variables["params"], "head": {"kernel": np.zeros(1)}},
                                            {"model": variables["batch_stats"]})
    model = TN.IRBackbone(num_layers=18, dropout=0.0, image_size=SIZE)
    model.load_state_dict(model_sd)
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert isinstance(model.features_bn, torch.nn.BatchNorm1d) and not model.features_bn.affine
    want = np.asarray(mut["batch_stats"]["features_bn"]["var"])
    # observed max relative error ~2e-6 (float32 batch statistics)
    np.testing.assert_allclose(model.features_bn.running_var.numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(model.features_bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["features_bn"]["mean"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.output_bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["output_bn"]["var"]), rtol=1e-4)


def _assert_trees_close(got_state, want_params, want_stats, start_params):
    """Every parameter within 1e-1 of its change over the steps (plus
    1e-6), every BatchNorm statistic and AdaFace's EMA within 1e-3 of the
    tensor's largest value (plus 1e-6). The first update carries the
    float32 gradients' error, which the JAX package's BatchNorm variance
    (E[x^2] - E[x]^2) dominates (tests/test_torch_port_train.py), and the
    second step's statistics see it."""
    got_params, got_stats = _port_tree(got_state)
    start = dict(_leaves(start_params))
    want = dict(_leaves(want_params))
    got = dict(_leaves(got_params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        moved = np.abs(w - start[path]).max()
        err = np.abs(got[path] - w).max()
        assert err <= 1e-1 * moved + 1e-6, (path, err, moved)
    want_s, got_s = dict(_leaves(want_stats)), dict(_leaves(got_stats))
    assert got_s.keys() == want_s.keys()
    for path, w in want_s.items():
        err, scale = np.abs(got_s[path] - w).max(), np.abs(w).max()
        assert err <= 1e-3 * scale + 1e-6, (path, err, scale)


@pytest.mark.parametrize("head_type", ["adaface", "arcface", "cosface"])
def test_two_train_steps_match_jax(head_type):
    model, head, jstate = _jax_state(head_type)
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    state = _port_state(jstate, head_type)
    jstep = JRT.make_train_step(model, head)
    step = RT.make_train_step()
    # Observed relative loss error: step 1 <= 6.4e-8 (the same weights),
    # step 2 ~1.1e-4 on one torch thread, 9e-7 on four: the first update's
    # float32 gradient error, moved by lr 0.1 through the s = 64 logits.
    for k, rtol in ((0, 1e-6), (1, 5e-4)):
        x, y = _batch(10 + k)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(k))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rtol)
        assert float(m["acc"]) == float(jm["acc"])
    assert state.step == int(jstate.step) == 2
    # Observed on one thread: a parameter's error <= 5.8% of its change
    # where that exceeds 1e-4 (0.31 of changes below 1e-6, inside the
    # floor); statistics <= 2.8e-4 of the tensor's largest value.
    _assert_trees_close(state, jstate.params, jstate.batch_stats, start)
    if head_type == "adaface":
        assert float(state.head.batch_mean) != 20.0


def test_aug_step_matches_jax_aug_step(monkeypatch):
    """Both augment on the device inside the step, at float32 (the JAX
    step's resample patched to float32, the port's asked for it), from the
    same draws: crops, flips and jitter (no low-res draw: its operators
    are held by tests/test_torch_port_recognition_augment.py)."""
    monkeypatch.setattr(JFDA, "device_augment_faces",
                        functools.partial(JFDA.device_augment_faces, resample_dtype=jnp.float32))
    model, head, jstate = _jax_state("adaface")
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    state = _port_state(jstate, "adaface")
    rng = np.random.default_rng(5)
    faces = np.stack([_rand_face(rng, SIZE) for _ in range(B)])
    draws = []
    for s in range(B):
        r = np.random.default_rng(100 + s)
        draws.append((D.draw_face_augment_params(r, SIZE, SIZE, 0.6, 0.0, 0.6), r.random() < 0.5))
    jplan = JFDA.stack_face_plans([JFDA.plan_face_sample(d, f, SIZE) for d, f in draws])
    plan = FDA.stack_face_plans([FDA.plan_face_sample(d, f, SIZE) for d, f in draws])
    labels = rng.integers(0, CLASSES, B).astype(np.int32)
    jstate, jm = JRT.make_train_step_aug(model, head)(
        jstate, jnp.asarray(faces), jplan, jnp.asarray(labels), jax.random.PRNGKey(0))
    step = RT.make_train_step_aug(resample_dtype=torch.float32)
    state, m = step(state, torch.from_numpy(faces), plan, torch.from_numpy(labels))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    _assert_trees_close(state, jstate.params, jstate.batch_stats, start)


def test_microbatches_match_one_batch_on_duplicated_halves():
    """The JAX package's own test and bounds
    (tests/test_recognition.py:248-291): with the batch two equal halves,
    each chunk's BatchNorm sees the whole batch's statistics, so two chunks
    give the one-batch update (CosFace: no EMA; dropout 0). Halves of 4,
    not the JAX test's 2: over two samples features_bn maps every pair to
    +-1 and the backbone's gradients are rounding noise (1.1e-3 apart at lr
    0.01 here); over four they carry signal. Observed: loss 3.5e-7
    relative, parameters 1.6e-5 apart."""
    _, _, jstate = _jax_state("cosface")
    half_x, half_y = _batch(7, n=4)
    x, y = np.concatenate([half_x, half_x]), np.concatenate([half_y, half_y])
    out = {}
    for mb in (1, 2):
        state = _port_state(jstate, "cosface")
        state, m = RT.make_train_step(microbatches=mb)(state, torch.from_numpy(x), torch.from_numpy(y))
        out[mb] = (float(m["loss"]), _port_tree(state)[0])
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for (path, a), (_, b) in zip(_leaves(out[1][1]), _leaves(out[2][1])):
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=2e-4, err_msg=str(path))
    with pytest.raises(ValueError, match="not divisible"):
        RT.make_train_step(microbatches=3)(_port_state(jstate, "cosface"), torch.from_numpy(x), torch.from_numpy(y))


def test_bf16_step_and_dropout_stream():
    """--precision 16: the backbone under bf16 autocast, parameters and head
    float32, loss finite and falling on one batch; dropout 0.4 draws the
    same mask for the same (seed, step)."""
    _, _, jstate = _jax_state("adaface")
    x, y = _batch(8)
    state = _port_state(jstate, "adaface")
    step = RT.make_train_step(compute_dtype="bfloat16")
    losses = []
    for _ in range(4):
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    runs = []
    for _ in range(2):
        s = _port_state(jstate, "adaface")
        s.model.dropout = 0.4
        s, m = RT.make_train_step(seed=3)(s, torch.from_numpy(x), torch.from_numpy(y))
        runs.append(float(m["loss"]))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_one_minus_p_and_scales(dtype):
    """flax Dropout's semantics in training mode, in float32 and under
    bf16 autocast (where output_bn hands dropout a bf16 map): each value
    kept with probability 1 - p, within 5 sigma, scaled by 1 / (1 - p)
    (exact: the division in the map's dtype), the rest 0, the gradient
    1 / (1 - p) on kept values and 0 elsewhere; the mask depends on the
    generator's seed only, not on the dtype; eval mode is the identity."""
    p, keep = 0.4, 0.6
    model = TN.IRBackbone(num_layers=18, dropout=p, image_size=SIZE).train()
    g = torch.Generator().manual_seed(0)
    h32 = torch.randn(64, 512, 4, 4, generator=g)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
        # The convolutions before output_bn run in bf16 under autocast.
        h = model.output_bn(h32.to(dtype)).detach().requires_grad_(True)
        out = model._dropout(h, torch.Generator().manual_seed(7))
    assert h.dtype == out.dtype == dtype
    kept = torch.rand(h.shape, generator=torch.Generator().manual_seed(7)) < keep
    n = kept.numel()
    frac = float(kept.float().mean())
    assert abs(frac - keep) <= 5 * (p * keep / n) ** 0.5, frac
    assert torch.equal(out[kept], (h / keep)[kept]) and not out[~kept].any()
    out_kept, h_kept = out.detach()[kept].float(), h.detach()[kept].float()
    scale = (out_kept / h_kept)[h_kept.abs() > 1e-3]
    assert float((scale * keep - 1).abs().max()) <= (2**-8 if dtype == torch.bfloat16 else 1e-6)
    out.float().sum().backward()
    assert torch.equal(h.grad[kept], torch.full_like(h.grad[kept], 1 / keep)) and not h.grad[~kept].any()
    model.eval()
    assert model._dropout(h, torch.Generator().manual_seed(7)) is h


def test_dropout_step_float32_matches_float64():
    """A train step at dropout 0.4 in float32 against the same step with a
    float64 backbone (the head float32 by design): the same generator seed
    draws the same mask, so every parameter lands within 1e-1 of its change
    (+ 1e-6) and every statistic within 1e-3 of its largest value, the
    bounds the JAX comparisons use; the mask moved the step (the loss
    differs from dropout 0's). Observed on one thread: loss 1.3e-7
    relative, parameters <= 3.7e-5 of their change where it exceeds 1e-4,
    the loss 0.128 from dropout 0's."""
    _, _, jstate = _jax_state("adaface")
    x, y = (torch.from_numpy(a) for a in _batch(9, n=8))
    runs = {}
    for name, dropout, f64 in (("f32", 0.4, False), ("f64", 0.4, True), ("no dropout", 0.0, False)):
        state = _port_state(jstate, "adaface")
        state.model.dropout = dropout
        if f64:
            state.model.double()
        state, m = RT.make_train_step(seed=3)(state, x, y)
        runs[name] = (float(m["loss"]), state)
    start_params = _port_tree(_port_state(jstate, "adaface"))[0]
    ref_params, ref_stats = _port_tree(runs["f64"][1])
    _assert_trees_close(runs["f32"][1], ref_params, ref_stats, start_params)
    np.testing.assert_allclose(runs["f32"][0], runs["f64"][0], rtol=1e-5)
    assert abs(runs["no dropout"][0] - runs["f32"][0]) > 1e-3


def _write_folder(root, n_classes=2, per=4, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"id{c}")
        os.makedirs(d)
        for i in range(per):
            Image.fromarray(_rand_face(rng, size)).save(os.path.join(d, f"{i}.png"))


def test_fit_checkpoints_resume_best_metrics(tmp_path, monkeypatch):
    """tests/test_recognition.py::test_fit_checkpoints_resume_best_metrics
    on the port: epoch checkpoints, a best-on-val_acc copy, metrics.csv,
    auto-resume (step, parameters, momentum) and --no-resume."""
    _write_folder(str(tmp_path / "data"))
    ds = D.ImageFolderDataset(str(tmp_path / "data"), output_size=SIZE)
    _, _, jstate = _jax_state("adaface")
    ckdir = str(tmp_path / "ck")
    step = RT.make_train_step()
    scores = iter([0.9, 0.5, 0.7])
    monkeypatch.setattr(RT, "validate_5sets", lambda *a, **k: {"mean": {"val_acc": next(scores)}})
    logs1 = []
    state = RT.fit(_port_state(jstate, "adaface"), step, ds, batch_size=4, epochs=2, seed=0, val_dir="fake",
                   checkpoint_dir=ckdir, log=logs1.append, device="cpu")
    assert state.step == 4
    rows = open(os.path.join(ckdir, "metrics.csv")).read().splitlines()
    assert rows[0] == "epoch,step,loss,acc,val_acc"
    assert len(rows) == 3 and rows[1].startswith("1,2,") and rows[1].endswith(",0.900000")
    assert json.load(open(os.path.join(ckdir, "best_meta.json"))) == {"epoch": 1, "val_acc": 0.9}
    assert sorted(os.listdir(os.path.join(ckdir, "best"))) == ["1.pt"]
    assert sorted(n for n in os.listdir(ckdir) if n.endswith(".pt")) == ["1.pt", "2.pt"]
    saved = torch.load(os.path.join(ckdir, "2.pt"), weights_only=True)
    assert sorted(saved) == ["head", "model", "optimizer", "step"] and saved["step"] == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k

    logs2 = []
    state2 = RT.fit(_port_state(jstate, "adaface"), step, ds, batch_size=4, epochs=3, seed=0,
                    checkpoint_dir=ckdir, log=logs2.append, device="cpu")
    assert any("resumed from checkpoint at epoch 2" in m for m in logs2)
    assert sum("loss=" in m for m in logs2) == 1 and state2.step == 6
    assert len(open(os.path.join(ckdir, "metrics.csv")).read().splitlines()) == 4
    # The resumed run continued the first: its momentum was restored.
    assert state2.optimizer.state_dict()["state"]
    logs3 = []
    RT.fit(_port_state(jstate, "adaface"), step, ds, batch_size=4, epochs=1, seed=0,
           checkpoint_dir=str(tmp_path / "ck2"), resume=False, log=logs3.append, device="cpu")
    assert not any("resumed" in m for m in logs3)


def test_cli_train_cpu_then_verify(tmp_path, capsys):
    """`recognition.cli train --device cpu` with each loader and bf16
    microbatches, a resume, and `verify --ckpt` on the checkpoint it wrote."""
    _write_folder(str(tmp_path / "data"), size=112)
    ck = str(tmp_path / "ck")
    base = ["train", "--data-root", str(tmp_path / "data"), "--arch", "ir_18", "--batch-size", "4", "--lr", "0.01",
            "--checkpoint-dir", ck, "--device", "cpu"]
    RC.main(base + ["--epochs", "1"])
    RC.main(base + ["--epochs", "2", "--device-augment", "--precision", "16", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "resumed from checkpoint at epoch 1" in out and "epoch 2/2" in out
    rows = open(os.path.join(ck, "metrics.csv")).read().splitlines()
    assert [r.split(",")[:2] for r in rows[1:]] == [["1", "2"], ["2", "4"]]
    vdir = tmp_path / "val"
    os.makedirs(vdir / "lfw" / "memfile")
    np.save(vdir / "lfw" / "memfile" / "lfw.npy", np.random.default_rng(0).normal(0, 1, (24, 112, 112, 3))
            .astype(np.float32))
    np.save(vdir / "lfw_list.npy", np.asarray([True, False] * 6))
    RC.main(["verify", "--arch", "ir_18", "--ckpt", os.path.join(ck, "2.pt"), "--data-dir", str(vdir),
             "--batch-size", "8", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["lfw", "mean"] and 0.0 <= res["mean"]["val_acc"] <= 1.0


@pytest.mark.parametrize("flag", ["--shard-head", "--fsdp"])
def test_cli_train_refusals(flag, tmp_path, monkeypatch):
    """The JAX CLI's exits: --shard-head with --microbatches, --fsdp
    without --shard-head (both run otherwise: tests/
    test_torch_port_parallel_recognition.py)."""
    extra, match = ((["--microbatches", "2"], "--microbatches with --shard-head") if flag == "--shard-head"
                    else ([], "--fsdp requires --shard-head"))
    with pytest.raises(SystemExit, match=match):
        RC.main(["train", "--data-root", str(tmp_path), flag, *extra, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RC.main(["train", "--data-root", str(tmp_path)])
