"""PyTorch port, profiling and capacity reporting (utils/profiling.py):

- `count_params` equals the JAX package's `count_params` of the `params`
  collection for all 21 presets at full depth (`jax.eval_shape`, no
  weights drawn);
- `flops_of` equals an analytic count of the convolutions and the NLM's
  two batched matmuls (FlopCounterMode counts those only); JAX's XLA
  cost-analysis GFLOPs are printed beside it, with no equality asserted
  (XLA also counts elementwise work and lowers the bicubic resize);
- the per-layer rows sum to the aggregate, params and FLOPs;
- `trace` writes a trace on the CPU, `benchmark` refuses to time without a
  card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.utils import profiling as JP
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.models.layers import NLM
from jabd_tpu_torch.utils import profiling as P
from tests._torch_port_steps import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("preset", sorted(TC.MODEL_PRESETS))
def test_count_params_matches_jax(preset):
    jcfg = JC.get_model_config(preset)
    model = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)
    )
    want = JP.count_params(shapes["params"])
    with torch.device("meta"):
        got = P.count_params(build_model(TC.get_model_config(preset), mode="eval", device="meta"))
    assert got == want and got > 0


def _analytic_flops(model, x):
    """2 per multiply-add of every conv (hooks on their outputs) and of the
    NLM's q @ k^T and attn @ v ([HW, ch] x [ch, S] and [HW, S] x [S, ch])."""
    total = []

    def conv(m, args, out):
        cin_g = m.in_channels // m.groups
        total.append(2 * out.numel() * cin_g * int(torch.tensor(m.kernel_size).prod()))

    def nlm(m, args, out):
        b, _, h, w = args[0].shape
        s = sum(p * p for p in m.psp_sizes)
        total.append(2 * 2 * b * h * w * s * m.ch)

    hooks = [mod.register_forward_hook(conv) for mod in model.modules()
             if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d))]
    hooks += [mod.register_forward_hook(nlm) for mod in model.modules() if isinstance(mod, NLM)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("preset", ["jabd_flagship", "retinaface_mnet025", "re50_eca_nonlocal"])
def test_flops_and_per_layer_rows(preset):
    size = 96
    cfg = dataclasses.replace(TC.get_model_config(preset), compute_dtype="float32")
    model = build_model(cfg, mode="eval", device="cpu").eval()
    x = torch.zeros((1, 3, size, size))
    fl = P.flops_of(model, x)
    assert fl == _analytic_flops(model, x) > 0
    rows = P.per_layer_table(model, x)
    assert [r["module"] for r in rows[:-2]] == [n for n, _ in model.named_children()]
    assert rows[-2]["module"] == "(other)" and rows[-1]["module"] == "TOTAL"
    assert rows[-1]["flops"] == fl and rows[-1]["params"] == P.count_params(model)
    assert sum(r["flops"] for r in rows[:-1]) == fl
    assert sum(r["params"] for r in rows[:-1]) == rows[-1]["params"]
    assert all(r["flops"] >= 0 and r["params"] >= 0 for r in rows)
    jcfg = dataclasses.replace(JC.get_model_config(preset), compute_dtype="float32")
    jmodel = jax_build_model(jcfg, mode="eval")
    xj = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.jit(functools.partial(jmodel.init, train=False))(jax.random.PRNGKey(0), xj)
    jfl = JP.flops_of(lambda v, i: jmodel.apply(v, i, train=False), variables, xj)
    print(f"{preset} {size}x{size}: port (convs, matmuls) {fl / 1e9:.4f} GFLOPs, JAX (XLA cost analysis) "
          f"{jfl / 1e9:.4f} GFLOPs")


def test_trace_and_benchmark(tmp_path):
    model = build_model(TC.get_model_config("retinaface_mnet025"), mode="eval", device="cpu").eval()
    with P.trace(str(tmp_path)) as prof, torch.no_grad():
        model(torch.zeros((1, 3, 32, 32)))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("conv" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.benchmark(lambda: None)
