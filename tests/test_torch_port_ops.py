"""PyTorch port, ops: anchors, box decode, resize/pool, letterbox, the
import boundary (the port never imports jax or the JAX package) and its
layering (`parallel/` and `recognition/` never reach up into the
detector's training module).

Each case feeds the same numpy inputs to the JAX function and its port.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jabd_tpu import configs as JC
from jabd_tpu.ops import anchors as JA
from jabd_tpu.ops import boxes as JB
from jabd_tpu.ops import image as JI
from jabd_tpu.ops import resize as JR
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import resolve_device
from jabd_tpu_torch.ops import anchors as TA
from jabd_tpu_torch.ops import boxes as TB
from jabd_tpu_torch.ops import image as TI
from jabd_tpu_torch.ops import resize as TR

PORT_MODULES = [
    "jabd_tpu_torch",
    "jabd_tpu_torch._build",
    "jabd_tpu_torch.aot",
    "jabd_tpu_torch.cli",
    "jabd_tpu_torch.configs",
    "jabd_tpu_torch.data",
    "jabd_tpu_torch.data.device_augment",
    "jabd_tpu_torch.data.wider",
    "jabd_tpu_torch.eval",
    "jabd_tpu_torch.eval.run_wider",
    "jabd_tpu_torch.eval.wider_eval",
    "jabd_tpu_torch.losses",
    "jabd_tpu_torch.models",
    "jabd_tpu_torch.models.epsa",
    "jabd_tpu_torch.models.fold",
    "jabd_tpu_torch.models.init",
    "jabd_tpu_torch.models.layers",
    "jabd_tpu_torch.models.mobilenet",
    "jabd_tpu_torch.models.quantize",
    "jabd_tpu_torch.models.resnet",
    "jabd_tpu_torch.models.retinaface",
    "jabd_tpu_torch.ops",
    "jabd_tpu_torch.ops.anchors",
    "jabd_tpu_torch.ops.boxes",
    "jabd_tpu_torch.ops.image",
    "jabd_tpu_torch.ops.matching",
    "jabd_tpu_torch.ops.matching_cuda",
    "jabd_tpu_torch.ops.nms",
    "jabd_tpu_torch.ops.nms_cuda",
    "jabd_tpu_torch.ops.resize",
    "jabd_tpu_torch.parallel",
    "jabd_tpu_torch.parallel.fsdp",
    "jabd_tpu_torch.parallel.mesh",
    "jabd_tpu_torch.parallel.spatial",
    "jabd_tpu_torch.parallel.spawn",
    "jabd_tpu_torch.pipeline",
    "jabd_tpu_torch.predict",
    "jabd_tpu_torch.recognition",
    "jabd_tpu_torch.recognition.align",
    "jabd_tpu_torch.recognition.cli",
    "jabd_tpu_torch.recognition.convert",
    "jabd_tpu_torch.recognition.data",
    "jabd_tpu_torch.recognition.device_augment",
    "jabd_tpu_torch.recognition.fold",
    "jabd_tpu_torch.recognition.heads",
    "jabd_tpu_torch.recognition.identification",
    "jabd_tpu_torch.recognition.ijbs",
    "jabd_tpu_torch.recognition.ijbs_proto",
    "jabd_tpu_torch.recognition.net",
    "jabd_tpu_torch.recognition.parallel",
    "jabd_tpu_torch.recognition.tinyface",
    "jabd_tpu_torch.recognition.torch_convert",
    "jabd_tpu_torch.recognition.train",
    "jabd_tpu_torch.recognition.verification",
    "jabd_tpu_torch.serve",
    "jabd_tpu_torch.step",
    "jabd_tpu_torch.train",
    "jabd_tpu_torch.utils",
    "jabd_tpu_torch.utils.checkpoint",
    "jabd_tpu_torch.utils.convert",
    "jabd_tpu_torch.utils.logging",
    "jabd_tpu_torch.utils.np_ckpt",
    "jabd_tpu_torch.utils.profiling",
    "jabd_tpu_torch.utils.torch_convert",
    "jabd_tpu_torch.utils.tracing",
]


def test_port_module_list_is_complete():
    import pathlib

    pkg = pathlib.Path(_repo_root()) / "jabd_tpu_torch"
    found = {
        ".".join(("jabd_tpu_torch",) + p.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    }
    assert found == set(PORT_MODULES)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Run in a fresh interpreter: this test process already holds jax.
    PIL, cv2, matplotlib and scipy are imported only where used, since the
    card's machine lacks some of them."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for name in {PORT_MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu",
                                            "PIL", "cv2", "matplotlib", "scipy"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())


def _imports(path):
    """(module, name) for every import in `path`, function-level ones
    included: name None for `import module`, else each name of a
    `from module import name`; and each attribute read off a name bound to
    a module by `from package import module` as (package.module, attr)."""
    tree = ast.parse(path.read_text())
    package = ".".join(path.relative_to(_repo_root()).with_suffix("").parts[:-1])
    found, modules = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.rsplit(".", node.level - 1)[0] if node.level > 1 else package
                base = f"{parent}.{base}".rstrip(".")
            for a in node.names:
                found.append((base, a.name))
                modules[a.asname or a.name] = f"{base}.{a.name}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id in modules:
            found.append((modules[node.value.id], node.attr))
    return found


@pytest.mark.parametrize("layer", ["parallel", "recognition"])
def test_lower_layers_never_import_the_detector_training_module(layer):
    """Every module under jabd_tpu_torch/<layer>/ imports neither
    `jabd_tpu_torch.train` nor `dropout_seed` from the detector model
    (it lives in `jabd_tpu_torch.step`), at import time or in a
    function."""
    bad = []
    for path in sorted((pathlib.Path(_repo_root()) / "jabd_tpu_torch" / layer).rglob("*.py")):
        for module, name in _imports(path):
            if module == "jabd_tpu_torch.train" or (module, name) == ("jabd_tpu_torch", "train"):
                bad.append((path.name, module, name))
            if name == "dropout_seed" and module.startswith("jabd_tpu_torch.models"):
                bad.append((path.name, module, name))
    assert not bad, bad


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(
        """
        import sys
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())


def test_recognition_training_path_imports_neither_jax_cv2_nor_the_jax_package(tmp_path):
    """The training path run, not only imported, in a fresh interpreter:
    both loaders over PNG faces (a low-res draw in every sample, so the
    host's cv2-free resize runs), the device augmentation and one step of
    each kind on ir_18 at 56x56. PIL decodes; cv2 never loads."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)).save(tmp_path / c / f"{i}.png")
    code = textwrap.dedent(
        f"""
        import sys, torch
        torch.set_num_threads(1)
        from jabd_tpu_torch.recognition import build_head, data as D, device_augment as FDA, train as RT
        from jabd_tpu_torch.recognition.net import IRBackbone
        ds = D.ImageFolderDataset({str(tmp_path)!r}, low_res_prob=1.0, output_size=56)
        images, labels = next(D.recognition_train_loader(ds, 4, num_workers=1))
        u8, plan, labels2 = next(FDA.device_face_train_loader(ds, 4, num_workers=1))
        state = RT.create_state(IRBackbone(18, dropout=0.4, image_size=56),
                                build_head("adaface", class_num=2, device="cpu"), 100)
        state, m = RT.make_train_step()(state, torch.from_numpy(images), torch.from_numpy(labels))
        state, m = RT.make_train_step_aug()(state, torch.from_numpy(u8), plan, torch.from_numpy(labels2))
        assert state.step == 2 and bool(torch.isfinite(m["loss"]))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu", "cv2"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())


LEARNING_SCRIPTS = [
    "scripts._torch_synthetic",
    "scripts.torch_overfit_sanity",
    "scripts.torch_overfit_device_augment",
    "scripts.torch_overfit_recognition",
    "scripts.torch_train_at_scale",
    "scripts.torch_resume_at_scale",
    "scripts.torch_train_recognition_at_scale",
    "scripts.torch_int8_ap_delta",
    "scripts.torch_int8_verification_delta",
]


def test_learning_scripts_import_neither_jax_cv2_tests_nor_the_jax_package(tmp_path):
    """The learning proofs' modules and chip_smoke.py (which imports their
    data generators) in a fresh interpreter, then every generator and a tiny
    `torch_train_at_scale` run (fit on the device-augment loader, a resume,
    the sweep and the evaluator) on the CPU: jax, the JAX package, tests/
    and cv2 never load. The card's machine has no jax, and tests/conftest.py
    imports it."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        import numpy as np, torch
        torch.set_num_threads(1)
        for name in {LEARNING_SCRIPTS!r} + ["chip_smoke"]:
            importlib.import_module(name)
        from scripts import _torch_synthetic as syn, torch_train_at_scale as T
        rng = np.random.default_rng(0)
        syn.build_dataset({str(tmp_path / "mini")!r}, 2, rng)
        bases = syn.build_identity_tree({str(tmp_path / "ids")!r}, rng, 2, 1)
        syn.build_val_bundle({str(tmp_path / "val")!r}, bases, rng, pairs=1)
        T.main(["--steps", "4", "--batch", "4", "--size", "64", "--images", "8", "--src-scale", "0.4",
                "--model", "mnet_v3_plain", "--device", "cpu", "--root", {str(tmp_path / "scale")!r}])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu", "tests", "cv2"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())


def test_compare_kernels_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(
        """
        import sys
        import compare_kernels
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())


def _repo_root():
    import pathlib

    return str(pathlib.Path(__file__).resolve().parents[1])


def test_entry_points_raise_without_a_device_or_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    from jabd_tpu_torch.pipeline import FacePipeline
    from jabd_tpu_torch.recognition import build_model
    from jabd_tpu_torch.recognition.train import extract_embeddings_tta

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("ir_18")
    model = build_model("ir_18", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FacePipeline(None, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_embeddings_tta(model, np.zeros((1, 112, 112, 3), np.float32))


def test_configs_are_a_faithful_copy():
    assert TC.MODEL_PRESETS.keys() == JC.MODEL_PRESETS.keys()
    for name in JC.MODEL_PRESETS:
        assert repr(TC.get_model_config(name)) == repr(JC.get_model_config(name))
    assert repr(TC.PredictConfig()) == repr(JC.PredictConfig())
    for name in JC.ANCHOR_PRESETS:
        assert repr(TC.ANCHOR_PRESETS[name]) == repr(JC.ANCHOR_PRESETS[name])
    with pytest.raises(KeyError):
        TC.get_model_config("nope")


@pytest.mark.parametrize(
    "preset,size",
    [("mnet", (840, 840)), ("mnet", (1280, 1280)), ("re50_self", (840, 840)),
     ("mnet", (640, 640)), ("mnet_4", (96, 160)), ("re101", (105, 77))],
)
def test_anchors_exact(preset, size):
    got = TA.generate_anchors(TC.ANCHOR_PRESETS[preset], size)
    want = JA.generate_anchors(JC.ANCHOR_PRESETS[preset], size)
    np.testing.assert_array_equal(got, want)  # exact
    assert len(got) == TA.num_anchors(TC.ANCHOR_PRESETS[preset], size)


def test_anchor_counts_of_the_reference():
    assert TA.num_anchors(TC.CFG_MNET, (840, 840)) == 29126
    assert TA.num_anchors(TC.CFG_MNET, (1280, 1280)) == 67200
    assert TA.num_anchors(TC.CFG_RE50_SELF, (840, 840)) == 29518


def test_decode_and_landmarks(rng):
    priors = TA.generate_anchors(TC.CFG_MNET, (64, 96))
    n = len(priors)
    loc = rng.normal(0, 1.5, (3, n, 4)).astype(np.float32)
    lm = rng.normal(0, 1.5, (3, n, 10)).astype(np.float32)
    v = (0.1, 0.2)
    want_b = np.asarray(JB.decode(jnp.asarray(loc), jnp.asarray(priors), v))
    want_l = np.asarray(JB.decode_landm(jnp.asarray(lm), jnp.asarray(priors), v))
    got_b = TB.decode(torch.from_numpy(loc), torch.from_numpy(priors.copy()), v).numpy()
    got_l = TB.decode_landm(torch.from_numpy(lm), torch.from_numpy(priors.copy()), v).numpy()
    # observed max error 2.4e-7 (exp rounding); stated tolerance 1e-6
    np.testing.assert_allclose(got_b, want_b, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_l, want_l, atol=1e-6, rtol=0)
    pf = TB.point_form(torch.from_numpy(priors.copy())).numpy()
    np.testing.assert_allclose(pf, np.asarray(JB.point_form(jnp.asarray(priors))), atol=1e-7)


@pytest.mark.parametrize(
    "in_hw,out_hw,mode",
    [((27, 27), (53, 53), "bicubic"), ((53, 53), (105, 105), "bicubic"),
     ((7, 11), (13, 20), "bicubic"), ((7, 11), (13, 20), "bilinear"),
     ((7, 11), (13, 20), "nearest"), ((27, 53), (53, 105), "nearest")],
)
def test_resize_matches_jax(rng, in_hw, out_hw, mode):
    x = rng.normal(0, 3, (2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(JR.resize(jnp.asarray(x), out_hw, mode=mode, align_corners=True))
    got = TR.resize(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw, mode=mode)
    # observed max error 6.7e-6 at |x| ~ 10 (f64-built matrices vs ATen f32 weights)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "in_hw,out_hw", [((27, 27), (8, 8)), ((53, 105), (6, 6)), ((13, 7), (3, 3)), ((5, 5), (8, 8))]
)
def test_adaptive_avg_pool_matches_jax(rng, in_hw, out_hw):
    x = rng.normal(0, 3, (2, *in_hw, 4)).astype(np.float32)
    want = np.asarray(JR.adaptive_avg_pool(jnp.asarray(x), out_hw))
    got = TR.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    # observed max error 3.6e-7; stated tolerance 1e-5
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "hw,target,exact",
    [((48, 96), (64, 64), False), ((50, 40), (64, 64), False),
     ((300, 200), (96, 96), False), ((37, 91), (96, 96), False),
     ((128, 96), (64, 64), True), ((64, 64), (64, 64), True),
     ((480, 640), (640, 640), True)],
)
def test_letterbox_within_one_grey_level(rng, hw, target, exact):
    """cv2 resizes uint8 in fixed point: 1 grey level is the floor (the
    observed max error is 1 on upscales and non-integer downscales). An
    exact 2x downscale (cv2 switches to INTER_AREA) and an unscaled image
    agree exactly."""
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = JI.letterbox_np(img, target)
    got = TI.letterbox_np(img, target)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= (0.0 if exact else 1.0)
    np.testing.assert_array_equal(got, np.round(got))  # whole grey levels
    fe_want = JI.serving_front_end(img, target)
    fe_got = TI.serving_front_end(img, target)
    assert np.abs(fe_got - fe_want).max() <= (0.0 if exact else 1.0)


def test_plain_resize_and_float_images(rng):
    img = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    want = JI.serving_front_end(img, (64, 48), letterbox=False)
    got = TI.serving_front_end(img, (64, 48), letterbox=False)
    assert np.abs(got - want).max() <= 1.0
    f = img.astype(np.float32)
    # float images are not rounded; observed max error 1.2e-3 (cv2 float path)
    np.testing.assert_allclose(
        TI.letterbox_np(f, (96, 96)), JI.letterbox_np(f, (96, 96)), atol=2e-3, rtol=0
    )


@pytest.mark.parametrize("image_hw", [(48, 96), (100, 37), (64, 64)])
def test_letterbox_geometry(image_hw):
    assert TI.letterbox_params(image_hw, (64, 80)) == JI.letterbox_params(image_hw, (64, 80))
    got = TI.correct_boxes_scale_offset((64, 80), image_hw)
    want = JI.correct_boxes_scale_offset((64, 80), image_hw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    x = np.full((2, 2, 3), 200.0, np.float32)
    np.testing.assert_array_equal(TI.preprocess_input_np(x), JI.preprocess_input_np(x))


def test_compare_train_step_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(
        """
        import sys
        import compare_train_step
        compare_train_step.run  # the turn a subprocess runs
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "jabd_tpu"))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_repo_root())
