"""PyTorch port, the detector step over a process mesh with microbatches
and remat, and with device augmentation too, on the CPU: two gloo ranks
against the JAX package's step on a 2-device CPU mesh (microbatches=2: its
scan's chunk c is global rows [2c, 2c + 2), split over the mesh; the
port's rank r takes its row of each chunk, `shard_batch(chunks=2)`), and
against the port's single-process step (float32 with the augmentation,
float64 without). jabd_flagship at 64x64, global batch 4, bucket
128x128."""

import pytest
import torch

from tests import _torch_port_parallel_tasks as T
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_augment_step import BUCKET, _augment_inputs
from tests.test_torch_port_parallel_train import BATCH, KW, SIZE, as_flax, assert_same_step, jax_mesh_step, payload, two_ranks
from tests.test_torch_port_train import _synthetic_batch

ALL = dict(microbatches=2, remat=True)


def test_microbatched_remat_step_matches_the_jax_mesh_step(tmp_path):
    variables = S.variables_for(SIZE)
    anchors = S.anchors_for(SIZE)
    images, targets = _synthetic_batch(3, bsz=BATCH)
    want = jax_mesh_step(dict(KW, matching_impl="pallas_interpret", **ALL), variables, (images,), targets, anchors)
    ranks = two_ranks(T.det_step, payload(variables, images, targets, anchors, train=ALL), tmp_path, "w")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    # test_torch_port_train.py's bounds (observed: loss terms 2.1e-7
    # relative, gradients 9.0e-4 per tensor, 1.9e-4 over all)
    S.assert_port_matches_jax(as_flax(ranks[0]), want)


def test_microbatched_augmented_remat_step_is_the_global_step_in_float64(tmp_path):
    """Each rank augments its row of each chunk: the 2-rank step against
    the port's single-process step on the same uint8 sources and plans, the
    frames cast to the float64 model, to 1e-6 as in
    test_torch_port_parallel_train.py (the single-process augmented step
    is held against the JAX package's in test_torch_port_augment_step.py).
    In float32 this batch is a poor witness: its chunks hold one image per
    rank, and at 64x64 the deepest BatchNorms see 2 images x 4 pixels, so
    the port's 2-rank and 1-process steps already differ by 0.1 of a
    gradient tensor (observed)."""
    variables = S.variables_for(SIZE)
    images, plan_t, _, targets = _augment_inputs(seed=3, bsz=BATCH)
    assert int(targets[3].sum()) > 0
    train = dict(ALL, device_augment=True, augment_bucket=BUCKET)
    data = payload(variables, images, targets, S.anchors_for(SIZE), train=train, dtype=torch.float64)
    data["inputs"] = (torch.from_numpy(images), plan_t)
    one = T.one_process(T.det_step, data)
    ranks = two_ranks(T.det_step, data, tmp_path, "w")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert_same_step(ranks[0], one, 1e-6)


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_microbatched_remat_step_is_the_global_step_in_float64(tmp_path, fsdp):
    """Ghost BatchNorm over the mesh: chunk c's statistics are those of
    global chunk c, the same on both ranks; to 1e-6 as in
    test_torch_port_parallel_train.py."""
    variables = S.variables_for(SIZE)
    images, targets = _synthetic_batch(5, bsz=BATCH)
    data = payload(variables, images, targets, S.anchors_for(SIZE), train=dict(ALL, fsdp=fsdp),
                   dtype=torch.float64)
    one = T.one_process(T.det_step, data)
    two = two_ranks(T.det_step, data, tmp_path, "w")
    assert two[0]["metrics"] == two[1]["metrics"]
    assert_same_step(two[0], one, 1e-6)
