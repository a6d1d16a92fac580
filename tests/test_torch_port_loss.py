"""PyTorch port, MultiBox loss (losses.py) and the box functions it uses
(ops/boxes.py) against the JAX package, float32 on the CPU.

The same numpy-made predictions and padded targets go through
`jabd_tpu.losses.multibox_loss` (XLA matching) and the port's
`multibox_loss`; the three terms and their gradients with respect to
(loc, conf, landm) are compared, for the smooth-L1 and the DIoU box loss.
One case draws each prior's class logits from four pairs, so that the
mining ranks fall into four groups of exactly equal values (equal in
both libraries, since equal inputs give equal outputs within each):
only a stable argsort, as jnp.argsort is, mines the same negatives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu import losses as JL
from jabd_tpu.ops import anchors as JA
from jabd_tpu.ops import boxes as JB
from jabd_tpu_torch import losses as TL
from jabd_tpu_torch.ops import boxes as TB

VAR = (0.1, 0.2)


def _random_boxes(rng, shape):
    cxy = rng.uniform(0.1, 0.9, shape + (2,))
    wh = rng.uniform(0.03, 0.4, shape + (2,))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def loss_problem(seed, tied_logits=False):
    rng = np.random.default_rng(seed)
    priors = JA.generate_anchors(JC.get_model_config("jabd_flagship").anchors, (128, 128)).copy()
    b, p, g = 3, priors.shape[0], 6
    loc = rng.normal(0, 0.5, (b, p, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (b, p, 2)).astype(np.float32)
    if tied_logits:
        pairs = np.asarray([[0.5, -0.5], [-1.0, 1.0], [2.0, 0.0], [0.0, 0.0]], np.float32)
        conf = pairs[rng.integers(0, 4, (b, p))]
    landm = rng.normal(0, 1, (b, p, 10)).astype(np.float32)
    boxes = _random_boxes(rng, (b, g))
    labels = rng.choice([1.0, -1.0], (b, g)).astype(np.float32)
    landms = rng.uniform(0, 1, (b, g, 10)).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[1, 4:] = False
    boxes[1, 4:] = 0.0
    valid[2, ::2] = False
    return priors, (loc, conf, landm), (boxes, labels, landms, valid)


def _jax_loss_and_grads(priors, preds, targets, box_loss):
    tg = JL.Targets(*(jnp.asarray(a) for a in targets))

    def total(loc, conf, landm):
        parts = JL.multibox_loss(
            (loc, conf, landm), jnp.asarray(priors), tg, box_loss=box_loss, matching_impl="xla"
        )
        return JL.total_loss(parts), parts

    (_, parts), grads = jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in preds)
    )
    return {k: float(v) for k, v in parts.items()}, [np.asarray(g) for g in grads]


def _port_loss_and_grads(priors, preds, targets, box_loss, matching_impl="auto"):
    leaves = [torch.tensor(a, requires_grad=True) for a in preds]
    parts = TL.multibox_loss(
        tuple(leaves), torch.from_numpy(priors), TL.Targets(*(torch.from_numpy(a) for a in targets)),
        box_loss=box_loss, matching_impl=matching_impl,
    )
    TL.total_loss(parts).backward()
    return {k: float(v.detach()) for k, v in parts.items()}, [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize(
    "box_loss,tied", [("smooth_l1", False), ("diou", False), ("smooth_l1", True)]
)
def test_multibox_loss_and_gradients_match_jax(box_loss, tied):
    priors, preds, targets = loss_problem(seed=3, tied_logits=tied)
    want, want_grads = _jax_loss_and_grads(priors, preds, targets, box_loss)
    got, got_grads = _port_loss_and_grads(priors, preds, targets, box_loss)
    for k in want:
        # observed relative error <= 3.3e-7 (summation order); stated 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for name, g, w in zip(("loc", "conf", "landm"), got_grads, want_grads):
        # observed max error <= 3.8e-9 on gradients up to 0.042; stated 1e-6
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5, err_msg=name)
        assert np.abs(w).max() > 0, name


def test_plain_matching_impl_gives_the_same_loss():
    priors, preds, targets = loss_problem(seed=4)
    auto, _ = _port_loss_and_grads(priors, preds, targets, "smooth_l1", "auto")
    plain, _ = _port_loss_and_grads(priors, preds, targets, "smooth_l1", "plain")
    assert auto == plain


def test_matching_impl_and_mesh_are_checked():
    priors, preds, targets = loss_problem(seed=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port_loss_and_grads(priors, preds, targets, "smooth_l1", "cuda")
    with pytest.raises(ValueError, match="not in"):
        _port_loss_and_grads(priors, preds, targets, "smooth_l1", "pallas")
    # A mesh of one (or none) is the plain path; the counts of a larger
    # one are summed over its ranks (tests/test_torch_port_parallel_train.py).
    from jabd_tpu_torch.parallel import mesh as M

    args = (tuple(torch.from_numpy(a) for a in preds), torch.from_numpy(priors),
            TL.Targets(*(torch.from_numpy(a) for a in targets)))
    plain = TL.multibox_loss(*args, matching_impl="plain")
    for mesh in (None, M.Mesh(["cpu"])):
        got = TL.multibox_loss(*args, matching_impl="plain", matching_mesh=mesh)
        assert all(torch.equal(got[k], plain[k]) for k in plain)


def test_box_functions_match_jax(rng):
    a = _random_boxes(rng, (5, 7))
    b = _random_boxes(rng, (5, 9))
    pairs = _random_boxes(rng, (5, 7))
    priors = rng.uniform(0.05, 0.5, (7, 4)).astype(np.float32)
    lm = rng.uniform(0, 1, (5, 7, 10)).astype(np.float32)
    x = rng.normal(0, 5, (4, 11, 2)).astype(np.float32)
    t = torch.from_numpy
    cases = [
        ("intersect", TB.intersect(t(a), t(b)), JB.intersect(a, b)),
        ("area", TB.area(t(a)), JB.area(a)),
        ("jaccard", TB.jaccard(t(a), t(b)), JB.jaccard(a, b)),
        ("elementwise_diou", TB.elementwise_diou(t(a), t(pairs)), JB.elementwise_diou(a, pairs)),
        ("encode", TB.encode(t(a), t(priors), VAR), JB.encode(a, priors, VAR)),
        ("encode_landm", TB.encode_landm(t(lm), t(priors), VAR), JB.encode_landm(lm, priors, VAR)),
        ("log_sum_exp", TB.log_sum_exp(t(x)), JB.log_sum_exp(x)),
        ("smooth_l1", TL.smooth_l1(t(x)), JL.smooth_l1(x)),
    ]
    for name, got, want in cases:
        # observed max error 4.8e-7 (encode's log), the rest exact; stated 2e-6
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-6, err_msg=name)
    # The 1e-12 clamp: a zero-width box encodes finitely.
    flat = a.copy()
    flat[..., 2] = flat[..., 0]
    got = TB.encode(t(flat), t(priors), VAR).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(JB.encode(flat, priors, VAR)), rtol=1e-6, atol=2e-6)
