"""PyTorch port, serving artifacts (aot.py), on the CPU at 64x64:

- the artifact's files, and a manifest with the JAX package's keys;
- the exported program holds K1 as one `jabd.nms_keep_sorted` node;
- the loaded artifact equals the live Predictor (`detect_preprocessed`,
  `detect_image`), and the JAX package's own artifact of the same
  variables (float32, XLA NMS) within a stated bound;
- an int8 Predictor exports its int8 graph, equal to live int8;
- the refusals: batch size, a newer version, another device, an embedder;
- a fresh interpreter loads and runs it importing no model code.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import aot as JAOT
from jabd_tpu import configs as JC
from jabd_tpu.models import build_model as jax_build_model
from jabd_tpu.predict import Predictor as JPredictor
from jabd_tpu_torch import aot
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch.models import quantize as Q
from jabd_tpu_torch.predict import Predictor
from jabd_tpu_torch.utils.convert import state_dict_from_flax
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import seeded_variables

SIZE, BATCH = 64, 2
PCFG = dict(confidence=0.3, input_shape=(SIZE, SIZE), max_detections=64, pre_nms_topk=256)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = dataclasses.replace(JC.get_model_config("jabd_flagship"), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get_model_config("jabd_flagship"), compute_dtype="float32")
    model = jax_build_model(jcfg, mode="eval")
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))
    )
    variables = seeded_variables(shapes, seed=6)
    pred = Predictor(tcfg, state_dict_from_flax(variables), TC.PredictConfig(**PCFG), device="cpu")
    out = str(tmp_path_factory.mktemp("art"))
    aot.export_detector(pred, out, batch_size=BATCH, model_name="jabd_flagship")
    x = np.random.default_rng(7).normal(0, 50, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, pred=pred, out=out, x=x)


def test_files_and_manifest(setup, tmp_path):
    assert sorted(os.listdir(setup["out"])) == ["graph.pt2", "manifest.json"]
    with open(os.path.join(setup["out"], "manifest.json")) as f:
        manifest = json.load(f)
    jpred = JPredictor(setup["jcfg"], setup["variables"], JC.PredictConfig(**PCFG), use_pallas=False)
    JAOT.export_detector(jpred, str(tmp_path), batch_size=BATCH, platforms=("cpu",), model_name="jabd_flagship")
    with open(tmp_path / "manifest.json") as f:
        jmanifest = json.load(f)
    # Every key of the JAX manifest but the Pallas switch, with its values.
    assert set(manifest) == set(jmanifest) - {"use_pallas"}
    for k in manifest:
        assert manifest[k] == jmanifest[k], k


def test_graph_holds_k1_as_one_node(setup):
    program = torch.export.load(os.path.join(setup["out"], "graph.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("jabd.nms_keep_sorted.default") == 1
    assert program.example_inputs is None  # the file holds no batch of zeros


def test_loaded_artifact_equals_live(setup, rng):
    art = aot.load_exported(setup["out"], device="cpu")
    d0, v0 = setup["pred"].detect_preprocessed(setup["x"])
    d1, v1 = art.detect_preprocessed(setup["x"])
    assert torch.equal(v0, v1) and int(v0.sum()) > 0
    torch.testing.assert_close(d1, d0, rtol=0, atol=0)  # the same ops on the same CPU
    # detect_image pads the artifact's batch of 2, the live Predictor runs
    # a batch of 1: other conv blocking, observed max abs diff 1.5e-5 px.
    img = rng.integers(0, 256, (50, 90, 3), dtype=np.uint8)
    got, want = art.detect_image(img), setup["pred"].detect_image(img)
    assert got.shape == want.shape and len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert (art.batch_size, art.input_shape, art.letterbox) == (BATCH, (SIZE, SIZE), True)


def test_matches_the_jax_artifact(setup, tmp_path):
    """The JAX package's artifact of the same variables (platforms cpu,
    XLA NMS) on the same batch. Float32 on both sides; observed: the same
    valid rows (78), max abs det diff 3.3e-7 (normalized coordinates)."""
    jpred = JPredictor(setup["jcfg"], setup["variables"], JC.PredictConfig(**PCFG), use_pallas=False)
    JAOT.export_detector(jpred, str(tmp_path), batch_size=BATCH, platforms=("cpu",))
    jd, jv = JAOT.load_exported(str(tmp_path)).detect_preprocessed(setup["x"])
    d, v = aot.load_exported(setup["out"], device="cpu").detect_preprocessed(setup["x"])
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(d.numpy()[v.numpy()], np.asarray(jd)[np.asarray(jv)], rtol=0, atol=1e-5)


def test_int8_artifact_equals_live_int8(setup, rng, tmp_path):
    pred = Predictor(setup["tcfg"], state_dict_from_flax(setup["variables"]), TC.PredictConfig(**PCFG), device="cpu")
    n = pred.quantize_int8(rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    aot.export_detector(pred, str(tmp_path), batch_size=BATCH)
    art = aot.load_exported(str(tmp_path), device="cpu")
    program = torch.export.load(str(tmp_path / "graph.pt2"))
    assert sum(1 for k in program.state_dict if k.endswith("kernel_q")) + sum(
        1 for k in program.constants if k.endswith("kernel_q")) == n
    d0, v0 = pred.detect_preprocessed(setup["x"])
    d1, v1 = art.detect_preprocessed(setup["x"])
    assert torch.equal(v0, v1) and torch.equal(d0, d1)
    assert any(isinstance(m, Q.QConv) for m in pred.model.modules())


def test_refusals(setup, tmp_path):
    art = aot.load_exported(setup["out"], device="cpu")
    with pytest.raises(ValueError, match="exported for batch 2"):
        art.detect_preprocessed(np.zeros((BATCH + 1, SIZE, SIZE, 3), np.float32))
    for name in os.listdir(setup["out"]):
        (tmp_path / name).write_bytes(open(os.path.join(setup["out"], name), "rb").read())
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    for change, err, match in (
        ({"version": aot.ARTIFACT_VERSION + 1}, ValueError, "newer than this loader"),
        ({"platforms": ["cuda"]}, ValueError, "loaded for 'cpu'"),
        ({"kind": "classifier"}, ValueError, "unknown artifact kind"),
    ):
        (tmp_path / "manifest.json").write_text(json.dumps({**manifest, **change}))
        with pytest.raises(err, match=match):
            aot.load_exported(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="exported on"):
        aot.export_detector(setup["pred"], str(tmp_path / "x"), platforms=("cuda",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aot.load_exported(setup["out"])


def test_fresh_interpreter_loads_without_model_code(setup):
    np.save(os.path.join(setup["out"], "..", "x.npy"), setup["x"])
    code = textwrap.dedent(
        f"""
        import sys, numpy as np, torch
        from jabd_tpu_torch import aot
        a = aot.load_exported({setup["out"]!r}, device="cpu")
        d, v = a.detect_preprocessed(np.load({os.path.join(setup["out"], "..", "x.npy")!r}))
        bad = sorted(m for m in sys.modules if m.startswith(("jabd_tpu_torch.models", "jabd_tpu_torch.predict",
                                                             "jax", "jabd_tpu.")))
        assert not bad, bad
        print(int(v.sum()))
        """
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=root, capture_output=True, text=True)
    _, v = setup["pred"].detect_preprocessed(setup["x"])
    assert int(out.stdout.split()[-1]) == int(v.sum())
