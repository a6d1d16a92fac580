"""PyTorch port, recognition over several ranks on the CPU: the
class-sharded head (recognition/parallel.py) on two gloo ranks against
`jabd_tpu/recognition/parallel.py::make_sharded_train_step` on a 2-device
CPU mesh, ir_18 at 56x56 with dropout 0, from the JAX state's weights
(utils/convert.py::rec_state_dicts_from_flax) and numpy-seeded batches of
4; and the data-parallel extraction:

- two sharded steps per head (AdaFace, ArcFace, CosFace): loss, acc, every
  parameter, the BatchNorm statistics and AdaFace's EMA buffers, with
  tests/test_torch_port_recognition_train.py's bounds; each rank holds
  half of the head's columns, the gathered checkpoint loads into the
  single-process state, and each step opens the `jabd.rectrain.*` spans;
- a padded head (7 classes -> 8) against the unpadded single-process step,
  an unpadded uneven head raising JAX's ValueError, and `fsdp=True`
  against the replicated backbone;
- `extract_embeddings_tta(mesh=)` over [cpu, cpu] against JAX's over its
  2-device mesh;
- `recognition.cli train --shard-head --fsdp --device cpu` on 2 ranks,
  then `verify --ckpt`, and the JAX CLI's exits.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jabd_tpu.recognition import heads as JH
from jabd_tpu.recognition import net as JN
from jabd_tpu.recognition import parallel as JRP
from jabd_tpu.recognition import train as JRT
from jabd_tpu_torch.parallel import mesh as M
from jabd_tpu_torch.parallel import spawn
from jabd_tpu_torch.recognition import heads as TH
from jabd_tpu_torch.recognition import net as TN
from jabd_tpu_torch.recognition import parallel as RP
from jabd_tpu_torch.recognition import train as RT
from jabd_tpu_torch.utils.convert import rec_state_dicts_from_flax
from tests import _torch_port_parallel_tasks as T
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_recognition_train import (
    CLASSES, LR, SIZE, _assert_trees_close, _batch, _write_folder,
)


def jax_mesh(n=2):
    return JMesh(np.asarray(jax.devices()[:n]), ("data",))


def _jax_state(head_type, classes=CLASSES, pad_to=0):
    model = JN.IRBackbone(num_layers=18, mode="ir", dropout=0.0)
    head = JH.build_head(head_type, class_num=classes, pad_to=pad_to)
    state = JRT.create_state(jax.random.PRNGKey(0), model, head, num_train_steps_hint=100, lr=LR,
                             milestones=(50,), image_size=SIZE)
    return model, head, state


def _payload(jstate, head_type, batches, classes=CLASSES, pad_to=0, **kw):
    model_sd, head_sd = rec_state_dicts_from_flax(jstate.params, jstate.batch_stats)
    return {
        "model": model_sd, "head": head_sd, "head_type": head_type, "classes": classes, "pad_to": pad_to,
        "size": SIZE, "lr": LR,
        "batches": [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches], **kw,
    }


def _two_ranks(fn, data, tmp_path, name="w"):
    return spawn.run(f"tests._torch_port_parallel_tasks:{fn.__name__}", 2, data, str(tmp_path / name))


def _as_state(payload, head_type, classes=CLASSES, pad_to=0):
    """A single-process RecTrainState loaded from a gathered checkpoint."""
    model = TN.IRBackbone(num_layers=18, mode="ir", dropout=0.0, image_size=SIZE)
    head = TH.build_head(head_type, class_num=classes, pad_to=pad_to, device="cpu")
    state = RT.create_state(model, head, num_train_steps_hint=100, lr=LR, milestones=(50,))
    state.load_state_dict(payload)
    return state


@pytest.mark.parametrize("head_type", ["adaface", "arcface", "cosface"])
def test_sharded_steps_match_the_jax_sharded_steps(head_type, tmp_path):
    model, head, jstate = _jax_state(head_type)
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    batches = [_batch(10 + k) for k in range(2)]
    data = _payload(jstate, head_type, batches)
    jstep, jstate = JRP.make_sharded_train_step(model, head, jstate, jax_mesh())
    jm = []
    for k, (x, y) in enumerate(batches):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(k))
        jm.append({k2: float(v) for k2, v in m.items()})
    ranks = _two_ranks(T.rec_steps, data, tmp_path)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    # step.run_step's span tree, on every rank
    phases = [f"jabd.rectrain.{p}" for p in ("forward", "head", "backward", "allreduce", "optimizer")]
    assert ranks[0]["spans"] == ranks[1]["spans"] == [phases] * len(batches)
    assert ranks[0]["head_local"] == (512, CLASSES // 2)
    # test_torch_port_recognition_train.py's bounds: step 1 to 1e-6 (the
    # same weights), step 2 to 5e-4 (the first update's float32 gradient
    # error through the s = 64 logits); acc exact.
    for k, rtol in ((0, 1e-6), (1, 5e-4)):
        np.testing.assert_allclose(ranks[0]["metrics"][k]["loss"], jm[k]["loss"], rtol=rtol)
        assert ranks[0]["metrics"][k]["acc"] == jm[k]["acc"]
    state = _as_state(ranks[0]["state"], head_type)
    assert state.step == int(jstate.step) == 2
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    _assert_trees_close(state, jparams, jax.tree_util.tree_map(np.asarray, jstate.batch_stats), start)
    if head_type == "adaface":
        jh = jstate.batch_stats["head"]
        assert float(state.head.batch_mean) != 20.0
        # the EMA of the global batch's norms, the same on both ranks
        np.testing.assert_allclose(float(state.head.batch_mean), float(jh["batch_mean"]), rtol=1e-4)
        np.testing.assert_allclose(float(state.head.batch_std), float(jh["batch_std"]), rtol=1e-3)
        for r in ranks:
            assert float(r["state"]["head"]["batch_std"]) == float(ranks[0]["state"]["head"]["batch_std"])


def test_padded_sharded_head_equals_the_unpadded_single_process_step(tmp_path):
    """7 classes padded to 8 over 2 ranks against 7 on one process: the
    padding columns take no softmax mass and no gradient. Bounds of
    test_torch_port_recognition_train.py (loss 1e-6 at step 1, 5e-4 at
    step 2; the kernel within 1e-1 of its change): both sides are float32,
    with each side's BatchNorm sums in its own order."""
    _, _, jstate = _jax_state("adaface", classes=7)
    batches = [(x, y % 7) for x, y in (_batch(20 + k) for k in range(2))]
    plain = _payload(jstate, "adaface", batches, classes=7)
    one = T.one_process(T.rec_steps, plain)
    model_sd, head_sd = plain["model"], dict(plain["head"])
    head_sd["kernel"] = torch.cat([head_sd["kernel"], torch.zeros(512, 1)], 1)
    padded = dict(plain, head=head_sd, pad_to=2)
    two = _two_ranks(T.rec_steps, padded, tmp_path)[0]
    for g, w, rtol in zip(two["metrics"], one["metrics"], (1e-6, 5e-4)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        assert g["acc"] == w["acc"]
    kernel = two["state"]["head"]["kernel"].numpy()
    assert kernel.shape == (512, 8)
    np.testing.assert_array_equal(kernel[:, 7], 0.0)  # no gradient reached the padding
    want = one["state"]["head"]["kernel"].numpy()
    moved = np.abs(want - plain["head"]["kernel"].numpy()).max()
    assert np.abs(kernel[:, :7] - want).max() <= 1e-1 * moved + 1e-6


def test_unpadded_uneven_head_raises_jax_text():
    head = TH.build_head("adaface", class_num=7, device="cpu")
    with pytest.raises(ValueError, match="head kernel class dim 7 does not divide across 2 devices"):
        RP.shard_head(head, M.Mesh(["cpu"], group="fake", size=2))
    _, _, jstate = _jax_state("adaface", classes=7)
    with pytest.raises(ValueError, match="head kernel class dim 7 does not divide across 2 devices"):
        JRP.rec_state_shardings(jstate, jax_mesh())


def test_fsdp_backbone_equals_the_replicated_one(tmp_path):
    _, _, jstate = _jax_state("cosface")
    data = _payload(jstate, "cosface", [_batch(30 + k) for k in range(2)])
    rep = _two_ranks(T.rec_steps, data, tmp_path, "rep")[0]
    sh = _two_ranks(T.rec_steps, dict(data, fsdp=True), tmp_path, "fsdp")[0]
    assert sh["metrics"] == rep["metrics"]
    for part in ("model", "head"):
        for k, v in rep["state"][part].items():
            if v.is_floating_point():  # observed equal
                np.testing.assert_allclose(sh["state"][part][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)
    moments = sh["state"]["optimizer"]["state"]
    assert moments.keys() == rep["state"]["optimizer"]["state"].keys()
    for i, st in moments.items():
        assert st["momentum_buffer"].shape == rep["state"]["optimizer"]["state"][i]["momentum_buffer"].shape


def test_sharded_extraction_matches_jax():
    model, _, jstate = _jax_state("adaface")
    variables = {"params": jstate.params["model"], "batch_stats": jstate.batch_stats["model"]}
    model_sd, _ = rec_state_dicts_from_flax(jstate.params, jstate.batch_stats)
    tmodel = TN.IRBackbone(num_layers=18, mode="ir", dropout=0.0, image_size=SIZE)
    tmodel.load_state_dict(model_sd)
    images = np.random.default_rng(6).uniform(-1, 1, (10, SIZE, SIZE, 3)).astype(np.float32)
    want = JRT.extract_embeddings_tta(model, variables, images, batch_size=4, mesh=jax_mesh())
    got = RT.extract_embeddings_tta(tmodel, images, batch_size=4, mesh=M.make_mesh(["cpu", "cpu"]))
    plain = RT.extract_embeddings_tta(tmodel, images, batch_size=4, device="cpu")
    for g, w, p in zip(got, want, plain):
        assert g.shape == w.shape
        # test_torch_port_recognition_eval.py's bound; observed 2e-6
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, p, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="must divide mesh size 2"):
        RT.extract_embeddings_tta(tmodel, images, batch_size=3, mesh=M.make_mesh(["cpu", "cpu"]))


def test_cli_train_shard_head_on_two_ranks_then_verify(tmp_path, capsys):
    """`train --shard-head --fsdp` on 2 ranks (3 identities, padded to 4),
    one epoch; rank 0 writes the checkpoint, which `verify --ckpt` reads on
    one process; then the JAX CLI's exits."""
    from jabd_tpu_torch.recognition import cli as RC

    _write_folder(str(tmp_path / "data"), size=112)
    ck = str(tmp_path / "ck")
    argv = ["train", "--data-root", str(tmp_path / "data"), "--arch", "ir_18", "--batch-size", "4",
            "--lr", "0.01", "--epochs", "1", "--checkpoint-dir", ck, "--shard-head", "--fsdp", "--device", "cpu"]
    _two_ranks(T.rec_cli, {"argv": argv}, tmp_path)
    saved = torch.load(os.path.join(ck, "1.pt"), weights_only=True)
    classes = len(os.listdir(tmp_path / "data"))
    assert saved["head"]["kernel"].shape == (512, -(-classes // 2) * 2)
    vdir = tmp_path / "val"
    os.makedirs(vdir / "lfw" / "memfile")
    np.save(vdir / "lfw" / "memfile" / "lfw.npy", np.random.default_rng(0).normal(0, 1, (24, 112, 112, 3))
            .astype(np.float32))
    np.save(vdir / "lfw_list.npy", np.asarray([True, False] * 6))
    RC.main(["verify", "--arch", "ir_18", "--ckpt", os.path.join(ck, "1.pt"), "--data-dir", str(vdir),
             "--batch-size", "8", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["lfw", "mean"] and 0.0 <= res["mean"]["val_acc"] <= 1.0
    with pytest.raises(SystemExit, match="--fsdp requires --shard-head"):
        RC.main(["train", "--data-root", str(tmp_path / "data"), "--fsdp", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--microbatches with --shard-head is not supported"):
        RC.main(["train", "--data-root", str(tmp_path / "data"), "--shard-head", "--microbatches", "2",
                 "--device", "cpu"])
