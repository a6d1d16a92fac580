"""PyTorch port, the mesh module (parallel/mesh.py) on the CPU:
`init_distributed` (a no-op alone, a second call tolerated, a bad address
raising), and on two gloo ranks `replicate_tree`, the collectives with
their gradients against the sums written out, and `prefetch_to_device`
over a process mesh. `make_mesh_for_batch` and `shard_batch` against the
JAX package are held in tests/test_torch_port_parallel_serve.py and
_train.py."""

import os

import pytest
import torch
import torch.distributed as dist

from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.parallel import spawn
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)


def test_init_distributed_alone_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    M.init_distributed()
    M.init_distributed(num_processes=1)
    assert not dist.is_initialized()
    mesh = M.process_mesh("cpu")
    assert mesh.size == 1 and mesh.rank == 0 and not mesh.is_process_mesh
    assert not M.is_sharded(mesh) and not M.is_local_sharded(mesh)


def test_init_distributed_raises_on_a_bad_address_and_missing_rank():
    with pytest.raises(ValueError, match="process_id are required"):
        M.init_distributed("127.0.0.1:1", num_processes=2)
    with pytest.raises(Exception):  # nothing listens on port 1: no silent fallback
        M.init_distributed("127.0.0.1:1", num_processes=2, process_id=1, initialization_timeout=2,
                           backend="gloo")
    assert not dist.is_initialized()


def test_collectives_and_helpers_on_two_ranks(tmp_path):
    address = f"file://{os.path.join(tmp_path, 'w', 'rendezvous')}"
    ranks = spawn.run("tests._torch_port_parallel_tasks:mesh_facts", 2, {"address": address}, str(tmp_path / "w"))
    for r, out in enumerate(ranks):
        assert out["initialized"] and out["size"] == 2 and out["rank"] == r
        assert torch.equal(out["weight"], torch.ones(2, 3))  # rank 0's, broadcast
        assert torch.equal(out["gathered"], torch.cat([torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)]))
        # d/dx of sum over ranks of sum_i i * y_i: rank r's rows are y[2r:2r+2],
        # weighed by i on both ranks, so 2 * i.
        want = 2 * torch.arange(2 * r, 2 * r + 2, dtype=torch.float32)[:, None].expand(2, 3)
        assert torch.equal(out["gather_grad"], want)
        # J = sum_r (r + 1) * (1 + 4): dJ/dz_r = 2 z_r * (1 + 2)
        assert torch.equal(out["sum"], torch.tensor([5.0]))
        assert torch.equal(out["sum_grad"], torch.tensor([2.0 * (r + 1) * 3]))
        assert torch.equal(out["fed"][0], torch.arange(8.0).reshape(4, 2)[2 * r : 2 * r + 2])
