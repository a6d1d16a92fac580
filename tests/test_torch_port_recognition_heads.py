"""PyTorch port, the margin heads (recognition/heads.py) against the JAX
package's flax heads, on the CPU in float32, from the same kernel (carried
by `utils/convert.rec_state_dicts_from_flax`) and the same numpy-seeded
embeddings, norms and labels:

- AdaFace, ArcFace and CosFace x train / eval x pad_to 0 / 3: the logits,
  their gradients with respect to the embeddings and the kernel
  (`jax.grad` against autograd), and AdaFace's norm EMA after the step;
- the target-column margin against the full-matrix oracle of
  tests/test_recognition.py::test_head_matches_full_matrix_oracle;
- the padding columns at -3e4 with no gradient, the refusal of an unknown
  type, the seeded init and the float32 product under a bf16 autocast.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu.recognition import heads as JH
from jabd_tpu_torch.recognition import heads as TH
from jabd_tpu_torch.utils.convert import rec_state_dicts_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401

CLASSES, B, D = 16, 8, 512


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (B, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    norms = rng.uniform(5, 40, (B, 1)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B).astype(np.int32)
    return emb, norms, labels


def _pair(head_type, pad_to):
    """(flax head, its variables, the port's head carrying the same
    kernel and statistics)."""
    jhead = JH.build_head(head_type, class_num=CLASSES, pad_to=pad_to)
    emb, norms, labels = _inputs()
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(emb), jnp.asarray(norms), jnp.asarray(labels))
    params = {"model": {}, "head": variables["params"]}
    stats = {"model": {}, "head": variables.get("batch_stats", {})}
    _, head_sd = rec_state_dicts_from_flax(params, stats)
    thead = TH.build_head(head_type, class_num=CLASSES, pad_to=pad_to, device="cpu")
    thead.load_state_dict(head_sd)
    return jhead, variables, thead


@pytest.mark.parametrize("pad_to", [0, 3])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("head_type", ["adaface", "arcface", "cosface"])
def test_head_matches_flax(head_type, train, pad_to):
    jhead, variables, thead = _pair(head_type, pad_to)
    emb, norms, labels = _inputs(1)
    width = TH._kernel_width(CLASSES, pad_to)
    cot = np.random.default_rng(2).normal(0, 1, (B, width)).astype(np.float32)

    def jloss(params, e):
        out = jhead.apply({**variables, "params": params}, e, jnp.asarray(norms), jnp.asarray(labels),
                          train=train, mutable=["batch_stats"] if train else False)
        logits, mut = out if train else (out, {})
        return jnp.sum(logits * cot), (logits, mut)

    (_, (want, mut)), (g_params, g_emb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(emb))
    thead.train(train)
    e = torch.from_numpy(emb).requires_grad_(True)
    got = thead(e, torch.from_numpy(norms), torch.from_numpy(labels))
    (got * torch.from_numpy(cot)).sum().backward()

    assert tuple(got.shape) == (B, width)
    # float32 both sides; observed max error over the 12 cases 7.6e-6 on
    # logits up to 64, 1.3e-5 on the embedding gradients, 3.8e-5 on the
    # kernel's (sums over the batch of s = 64-scaled terms).
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_emb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(thead.kernel.grad.numpy(), np.asarray(g_params["kernel"]), rtol=1e-4, atol=1e-6)
    if pad_to:
        assert (got[:, CLASSES:] == -3e4).all()
        assert (thead.kernel.grad[:, CLASSES:] == 0).all()
    if head_type == "adaface":
        stats = mut.get("batch_stats", variables["batch_stats"])
        moved = float(thead.batch_mean) != 20.0
        assert moved == train
        np.testing.assert_allclose(float(thead.batch_mean), float(stats["batch_mean"]), rtol=1e-6)
        np.testing.assert_allclose(float(thead.batch_std), float(stats["batch_std"]), rtol=1e-6)


@pytest.mark.parametrize("head_type", ["adaface", "arcface"])
def test_head_matches_full_matrix_oracle(head_type):
    """The target-column margin equals arccos / cos over the whole [B, C]
    matrix (the bounds of the JAX package's own oracle test)."""
    _, _, thead = _pair(head_type, 0)
    thead.eval()
    emb, norms, labels = _inputs(3)
    m, s, eps, h = 0.4, 64.0, 1e-3, 0.333

    def oracle(e):
        kernel = thead.kernel.detach()
        kernel = kernel / kernel.norm(dim=0, keepdim=True)
        cosine = (e @ kernel).clamp(-1 + eps, 1 - eps)
        onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(), CLASSES).float()
        if head_type == "adaface":
            scaler = ((torch.from_numpy(norms)[:, 0] - 20.0) / (100.0 + eps) * h).clamp(-1, 1)
            m_arc, m_cos = -m * scaler[:, None] * onehot, (m * scaler[:, None] + m) * onehot
        else:
            m_arc, m_cos = m * onehot, 0.0
        return (torch.cos((torch.arccos(cosine) + m_arc).clamp(eps, math.pi - eps)) - m_cos) * s

    cot = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (B, CLASSES)).astype(np.float32))
    grads = []
    for fn in (lambda e: thead(e, torch.from_numpy(norms), torch.from_numpy(labels)), oracle):
        e = torch.from_numpy(emb).requires_grad_(True)
        out = fn(e)
        (out * cot).sum().backward()
        grads.append((out.detach().numpy(), e.grad.numpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(grads[0][1], grads[1][1], rtol=2e-4, atol=2e-4)


def test_build_head_seeds_refuses_and_stays_float32():
    a = TH.build_head("AdaFace", class_num=10, seed=3, device="cpu")
    b = TH.build_head("adaface", class_num=10, seed=3, device="cpu")
    assert torch.equal(a.kernel, b.kernel) and a.kernel.dtype == torch.float32
    assert tuple(a.kernel.shape) == (512, 10)
    assert abs(float(a.kernel.detach().std()) - 0.01) < 1e-3
    assert sorted(dict(a.named_buffers())) == ["batch_mean", "batch_std"]
    assert TH._kernel_width(10, 4) == 12 and TH._kernel_width(10, 1) == 10
    with pytest.raises(ValueError, match="unknown head type"):
        TH.build_head("sphereface", device="cpu")
    emb, norms, labels = _inputs(5)
    c = TH.build_head("cosface", class_num=CLASSES, device="cpu")
    args = (torch.from_numpy(emb), torch.from_numpy(norms), torch.from_numpy(labels))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        inside = c(*args)
    assert inside.dtype == torch.float32
    assert torch.equal(inside, c(*args))
