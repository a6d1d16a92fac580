"""PyTorch port against the recognition golden fixture
(tests/fixtures/golden_recognition, made by
scripts/make_recognition_golden.py with the JAX package):

- chip_smoke.golden_ir_state_dict, the port's copy of the fixture's
  path-keyed filler, equals `deterministic_variables()` leaf for leaf;
- the two scenes, decoded by chip_smoke.read_png and aligned by the
  port, are byte-equal to the golden crops; their embeddings through
  `FacePipeline.embed_crops` (ir_18, float32) are within 1e-4 of the
  golden embeddings, and their cosine within 1e-4 (the JAX package's own
  bounds, tests/test_golden_recognition.py).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

import chip_smoke
from jabd_tpu_torch.pipeline import FacePipeline
from jabd_tpu_torch.recognition import build_model
from jabd_tpu_torch.recognition.align import align_face
from jabd_tpu_torch.utils.convert import flax_from_state_dict
from tests._torch_port_steps import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "golden_recognition")


@pytest.fixture(scope="module")
def gen():
    spec = importlib.util.spec_from_file_location(
        "make_recognition_golden", os.path.join(ROOT, "scripts", "make_recognition_golden.py")
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_filler_equals_deterministic_variables(gen):
    _, variables = gen.deterministic_variables()
    ported = flax_from_state_dict(chip_smoke.golden_ir_state_dict("ir_18"))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(ported))
    for path, leaf in flat:
        node = ported
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def test_golden_crops_and_embeddings():
    golden = dict(np.load(os.path.join(FIXTURE_DIR, "golden.npz")))
    crops = []
    for stem in ("scene_0", "scene_1"):
        scene = chip_smoke.read_png(os.path.join(FIXTURE_DIR, stem + ".png"))
        crop = align_face(scene, golden[f"landmarks_{stem}"])
        np.testing.assert_array_equal(crop, golden[f"crop_{stem}"])
        crops.append(crop)
    model = build_model("ir_18", device="cpu")
    model.load_state_dict(chip_smoke.golden_ir_state_dict("ir_18"))
    emb = FacePipeline(None, model, device="cpu").embed_crops(np.stack(crops))
    # observed max error 3.6e-7
    np.testing.assert_allclose(emb, golden["embeddings"], rtol=1e-4, atol=1e-4)
    n = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    np.testing.assert_allclose(float(n[0] @ n[1]), float(golden["cosine_01"]), atol=1e-4)
