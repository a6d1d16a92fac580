"""PyTorch port, FSDP under the JAX package's leaf rule (parallel/fsdp.py)
on the CPU:

- `leaf_spec` against `jabd_tpu/parallel/fsdp.py::leaf_spec` on every
  parameter of all 21 presets at N = 2, 4, 8 (the flax shapes from
  jax.eval_shape, no JIT; the port's from the meta device): the same axis
  on the same shape, and on the port's own layouts the same sharded sizes,
  so the same bytes shard as in tests/test_fsdp_census.py;
- `assert_sharded` on a 2-rank FSDP model, and on one that is not sharded;
- the per-rank parameter + Adam bytes of a 2-rank FSDP step against the
  rule's count;
- `fit` with fsdp over 2 ranks: identical ranks, a full-state checkpoint in
  the single-process layout that a plain model and optimizer load, and a
  resume from it.

The FSDP step itself is held against the JAX mesh step and the port's
replicated step in tests/test_torch_port_parallel_train.py.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.parallel import fsdp as JF
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.models import build_model
from jabd_tpu_torch.parallel import fsdp as FS
from jabd_tpu_torch.parallel import mesh as M
from tests import _torch_port_parallel_tasks as T
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_parallel_train import BATCH, KW, SIZE, payload, two_ranks
from tests.test_torch_port_train import _synthetic_batch


def _axis(spec):
    axes = [i for i, a in enumerate(spec) if a is not None]
    return axes[0] if axes else None


def _sharded_sizes(shapes, n):
    """Sorted (numel, size of the sharded dim or 0) of every shape."""
    out = []
    for shape in shapes:
        axis = FS.leaf_spec(shape, n)
        out.append((math.prod(shape), 0 if axis is None else shape[axis]))
    return sorted(out)


@pytest.mark.parametrize("name", sorted(TC.MODEL_PRESETS))
def test_leaf_spec_is_the_jax_rule_on_every_preset(name):
    cfg = dataclasses.replace(JC.get_model_config(name), compute_dtype="float32")
    model = jax_build_model(cfg, mode="train")
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flax_shapes = [leaf.shape for leaf in jax.tree_util.tree_leaves(shapes["params"])]
    port_shapes = [tuple(p.shape) for p in build_model(TC.get_model_config(name), device="meta").parameters()]
    assert len(flax_shapes) == len(port_shapes)
    for n in (2, 4, 8):
        for shape in flax_shapes:
            assert FS.leaf_spec(shape, n) == _axis(JF.leaf_spec(shape, n)), (shape, n)
        assert _sharded_sizes(port_shapes, n) == _sharded_sizes(flax_shapes, n), n


def test_leaf_spec_rule():
    assert FS.leaf_spec((8191,), 2) is None  # under MIN_SHARD_SIZE
    assert FS.leaf_spec((3, 3, 64, 64), 2) == 2  # the first of equal largest
    assert FS.leaf_spec((64, 64, 3, 3), 2) == 0
    assert FS.leaf_spec((7, 3, 3, 131), 2) is None  # nothing divides
    assert FS.leaf_spec((96, 8192), 3) == 0  # the largest that divides
    assert FS.MIN_SHARD_SIZE == JF.MIN_SHARD_SIZE


def test_assert_sharded_refuses_a_replicated_model():
    model = build_model(S.model_cfgs()[1], device="cpu")
    with pytest.raises(AssertionError, match="expected 1/2 shards"):
        FS.assert_sharded(model, M.Mesh(["cpu"], group="fake", size=2))
    FS.assert_sharded(model, M.Mesh(["cpu"]))  # a mesh of one shards nothing


def test_two_rank_fsdp_step_holds_half_of_each_sharded_leaf(tmp_path):
    """After one step: every leaf the rule shards is a DTensor of 1/2 on
    each rank (assert_sharded inside the task), and each rank's parameter +
    Adam bytes are the rule's count (sharded leaves halved)."""
    variables = S.variables_for(SIZE)
    images, targets = _synthetic_batch(0, bsz=BATCH)
    data = payload(variables, images, targets, S.anchors_for(SIZE), train={"fsdp": True})
    ranks = two_ranks(T.det_step, data, tmp_path, "w")
    model = build_model(S.model_cfgs()[1], device="meta")
    params = list(model.parameters())
    sharded = [p for p in params if FS.leaf_spec(p.shape, 2) is not None]
    local = sum(p.numel() // (2 if FS.leaf_spec(p.shape, 2) is not None else 1) for p in params)
    # parameters + Adam's two moments, 4 bytes each, + one step counter per parameter
    want = 3 * 4 * local
    for r in ranks:
        assert r["n_dtensor"] == len(sharded) > 0
        assert want <= r["bytes"] <= want + 8 * len(params)
    replicated = 3 * 4 * sum(p.numel() for p in params)
    assert ranks[0]["bytes"] < 0.6 * replicated


def test_fsdp_fit_checkpoint_loads_single_process_and_resumes(tmp_path):
    kw = dict(KW, total_epochs=2, freeze_epochs=1, save_period=1, matching_impl="plain", fsdp=True)
    data = {"kw": kw, "n": 8, "dir": str(tmp_path / "run")}
    ranks = two_ranks(T.det_fit, data, tmp_path, "w")
    assert ranks[0]["fingerprint"] == ranks[1]["fingerprint"]
    assert ranks[0]["steps"] == [1, 2]
    payload_ = torch.load(tmp_path / "run" / "ck" / "2.pt", weights_only=True)
    cfg = S.model_cfgs()[1]
    state = TT.create_train_state(cfg, TC.TrainConfig(**kw), 2, lr=1e-4, device="cpu")
    state.load_state_dict(payload_)  # the single-process layout, optimizer included
    got = {k: float(v.double().sum()) for k, v in state.model.state_dict().items() if v.is_floating_point()}
    assert got == ranks[0]["fingerprint"]
    moments = [st["exp_avg"] for st in state.optimizer.state.values()]
    assert moments and all(m.shape == p.shape for m, p in zip(moments, state.model.parameters()))
    again = two_ranks(T.det_fit, dict(data, kw=dict(kw, total_epochs=3)), tmp_path, "w2")
    assert again[0]["steps"] == [1, 2, 3] and again[0]["step"] == 6
    assert again[0]["fingerprint"] == again[1]["fingerprint"]


def test_cli_train_under_torchrun_with_fsdp(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    jabd_tpu_torch.cli train --fsdp --device cpu`: init_distributed reads
    torchrun's environment, fit trains over the process group, rank 0
    writes the checkpoint (the single-process layout) and metrics.csv."""
    import os
    import subprocess
    import sys

    import cv2
    import numpy as np

    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(8):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.png"), rng.integers(0, 256, (80, 96, 3), dtype=np.uint8))
        lines += [f"# {i}.png", "20 16 40 36 " + " ".join(["30 26 0.0"] * 5) + " 1.0"]
    (tmp_path / "label.txt").write_text("\n".join(lines) + "\n")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "jabd_tpu_torch.cli", "train", "--label-txt", str(tmp_path / "label.txt"), "--model", "jabd_flagship",
           "--batch-size", "4", "--input-size", "64", "--epochs", "1", "--freeze-epochs", "0", "--fsdp",
           "--matching-impl", "plain", "--ckpt-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "lg"),
           "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert done.stdout.count("epoch 1/1") == 1  # rank 0 alone logs
    rows = (tmp_path / "lg" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("1,2,")
    saved = torch.load(tmp_path / "ck" / "1.pt", weights_only=True)
    model = build_model(TC.get_model_config("jabd_flagship"), mode="train", device="cpu")
    model.load_state_dict(saved["model"])
    assert saved["step"] == 2
