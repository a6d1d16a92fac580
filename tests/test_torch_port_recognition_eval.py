"""PyTorch port, the recognition evaluators and their CLI against the JAX
package, on the CPU in float32, on seeded synthetic data (no face
checkpoint or validation set is in the repo):

- verification (`kfold_splits` equal to sklearn's KFold, `evaluate`,
  `calculate_val`), identification (`find_thresholds_by_FAR`, `DIR_FAR`,
  `RankRetrievalTest`) and the fusion of every method: equal to the JAX
  package's (numpy on both sides; exact);
- TinyFace over .mat protocol files, IJB-S templates and the cs6 protocol
  tree (tests/test_lq_protocols.py's `ijbs_proto_tree`): equal to JAX's;
- `extract_embeddings_tta` with and without flip, tail padded (within
  1e-5 of JAX's), `extract_features_partitioned` against JAX's (1e-5)
  and resuming from its part files, `validate_5sets` on a partial bundle (a `.bin` of PIL-written
  JPEGs and a memfile) against JAX's (within 1e-6) and its
  FileNotFoundError;
- a reference-layout IR-18 `.pth` (tests/test_torch_convert_more.py's
  TIR18) through `ir_state_dict_from_pth` against the module itself;
  `recognition.cli._load_images` against the JAX package's cv2 loader;
- `recognition.cli` verify / tinyface / extract against the JAX CLI on
  that `.pth`, ijbs, export, and `AotEmbedder` against the live model and
  against the JAX artifact.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from jabd_tpu import aot as JAOT
from jabd_tpu.recognition import cli as JRC
from jabd_tpu.recognition import data as JD
from jabd_tpu.recognition import identification as JID
from jabd_tpu.recognition import ijbs as JIJ
from jabd_tpu.recognition import net as JN
from jabd_tpu.recognition import tinyface as JTF
from jabd_tpu.recognition import train as JRT
from jabd_tpu.recognition import verification as JV
from jabd_tpu_torch import aot
from jabd_tpu_torch.recognition import build_model
from jabd_tpu_torch.recognition import cli as RC
from jabd_tpu_torch.recognition import convert as RCONV
from jabd_tpu_torch.recognition import data as D
from jabd_tpu_torch.recognition import identification as ID
from jabd_tpu_torch.recognition import ijbs as IJ
from jabd_tpu_torch.recognition import tinyface as TF
from jabd_tpu_torch.recognition import train as RT
from jabd_tpu_torch.recognition import verification as V
from jabd_tpu_torch.recognition.torch_convert import ir_state_dict_from_pth
from jabd_tpu_torch.utils.convert import flax_from_state_dict
from jabd_tpu_torch.utils.torch_convert import load_pth
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_lq_protocols import ijbs_proto_tree  # noqa: F401
from tests.test_torch_convert_more import TIR18, _randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n", [10, 23, 600])
def test_kfold_splits_equal_sklearn(n):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=10, shuffle=False).split(np.arange(n)))
    got = list(V.kfold_splits(n, 10))
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_verification_matches_jax(rng):
    protos = _unit(rng.normal(0, 1, (300, 64)))
    emb = np.empty((600, 64), np.float32)
    issame = rng.random(300) < 0.5
    emb[0::2] = protos
    other = _unit(rng.normal(0, 1, (300, 64)))
    emb[1::2] = np.where(issame[:, None], _unit(protos + rng.normal(0, 0.3, protos.shape)), other)
    for got, want in zip(V.evaluate(emb, issame), JV.evaluate(emb, issame)):
        np.testing.assert_array_equal(got, want)
    thr = np.arange(0, 4, 0.01)

    def val(mod, far):
        try:
            return mod.calculate_val(thr, emb[0::2], emb[1::2], issame, far)
        except ValueError as e:  # the reference's interp1d refuses repeated FARs
            return str(e)

    for far in (1e-1, 2.0):
        assert val(V, far) == val(JV, far)
    e, n = V.l2_norm(emb * 3)
    np.testing.assert_array_equal(e, JV.l2_norm(emb * 3)[0])
    stacked = np.stack([emb[:8], emb[8:16]])
    norms = rng.uniform(5, 20, (2, 8, 1)).astype(np.float32)
    for got, want in zip(V.fuse_features_with_norm(stacked, norms), JV.fuse_features_with_norm(stacked, norms)):
        np.testing.assert_array_equal(got, want)


def test_identification_matches_jax(rng):
    score = rng.normal(0, 1, (20, 30)).astype(np.float32)
    label = np.zeros((20, 30), bool)
    label[np.arange(15), rng.integers(0, 30, 15)] = True  # 5 probes without a mate
    for got, want in zip(ID.DIR_FAR(score, label, ranks=[1, 5], FARs=[0.01, 0.1, 1.0]),
                         JID.DIR_FAR(score, label, ranks=[1, 5], FARs=[0.01, 0.1, 1.0])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ID.find_thresholds_by_FAR(score.ravel(), label.ravel(), [0.0, 0.01, 0.5, 1.0]),
                                  JID.find_thresholds_by_FAR(score.ravel(), label.ravel(), [0.0, 0.01, 0.5, 1.0]))
    probe, gal = _unit(rng.normal(0, 1, (6, 16))), _unit(rng.normal(0, 1, (9, 16)))
    pl, gl = rng.integers(0, 6, 6), np.arange(6)
    assert ID.RankRetrievalTest(pl, gl, 3).identification(probe, gal, (1, 5)) == JID.RankRetrievalTest(
        pl, gl, 3).identification(probe, gal, (1, 5))


@pytest.mark.parametrize("method", ["average", "norm_weighted_avg", "pre_norm_vector_add", "concat",
                                    "faceness_score"])
def test_fusion_matches_jax(method, rng):
    e = _unit(rng.normal(0, 1, (2, 12, 16)))
    n = rng.uniform(5, 30, (2, 12, 1)).astype(np.float32)
    fs = rng.uniform(0.1, 1.0, 12).astype(np.float32) if method == "faceness_score" else None
    got = ID.fuse_features_with_norm(e, n, method, faceness_scores=fs)
    want = JID.fuse_features_with_norm(e, n, method, faceness_scores=fs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _tinyface_tree(root, rng, n_ids=4):
    """A TinyFace layout: the two protocol .mat files, probe / gallery
    PNGs (one of them off-size, resized to 112 on load) and distractors."""
    import scipy.io as sio

    align = root / "aligned_pad_0.1_pad_high"
    for sub in ("Probe", "Gallery_Match", "Gallery_Distractor"):
        os.makedirs(align / sub)
    probes, gallery = [], []
    for i in range(n_ids):
        face = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
        Image.fromarray(face).save(align / "Probe" / f"{i}_p.png")
        Image.fromarray(face if i else face[:90, :100]).save(align / "Gallery_Match" / f"{i}_g.png")
        probes.append(f"{i}_p.png")
        gallery.append(f"{i}_g.png")
    for k in range(3):
        Image.fromarray(rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)).save(
            align / "Gallery_Distractor" / f"d{k}.png")
    mat_dir = root / "tinyface" / "Testing_Set"
    os.makedirs(mat_dir)

    def cell(names):  # a MATLAB cell array of (image name, subject id) rows
        c = np.empty((len(names), 2), dtype=object)
        for i, n in enumerate(names):
            c[i] = n, float(n.split("_")[0])
        return c

    sio.savemat(mat_dir / "probe_img_ID_pairs.mat", {"probe_set": cell(probes)})
    sio.savemat(mat_dir / "gallery_match_img_ID_pairs.mat", {"gallery_set": cell(gallery)})
    return root


def test_tinyface_and_ijbs_match_jax(tmp_path, rng):
    root = _tinyface_tree(tmp_path, rng)
    t, jt = TF.TinyFaceTest(str(root)), JTF.TinyFaceTest(str(root))
    assert t.image_paths == jt.image_paths and len(t.image_paths) == 11
    feats = _unit(rng.normal(0, 1, (11, 16)))
    assert t.test_identification(feats) == jt.test_identification(feats)
    groups = {s: [2 * s, 2 * s + 1] for s in range(5)}
    f = _unit(rng.normal(0, 1, (10, 16)))
    tt, jtt = IJ.build_templates(f, groups), JIJ.build_templates(f, groups)
    for a, b in zip(tt, jtt):
        np.testing.assert_array_equal(a.feature, b.feature)


def test_ijbs_protocols_match_jax(ijbs_proto_tree, rng, tmp_path, capsys):  # noqa: F811
    root, paths, subjects = ijbs_proto_tree
    protos = _unit(rng.normal(0, 1, (7, 48)))
    feats = _unit(protos[subjects - 1] + rng.normal(0, 0.2, (len(subjects), 48)))
    norms = rng.uniform(8, 25, (len(subjects), 1)).astype(np.float32)
    npz = tmp_path / "features.npz"
    np.savez(npz, emb=feats, norm=norms, paths=np.asarray(paths))
    outs = []
    for main in (RC.main, JRC.main):
        main(["ijbs", "--features", str(npz), "--protocol-dir", str(root)])
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and len(outs[0]) == 5


@pytest.fixture(scope="module")
def golden18():
    state = chip_smoke.golden_ir_state_dict("ir_18")
    model = build_model("ir_18", device="cpu")
    model.load_state_dict(state)
    return model, JN.build_model("ir_18"), flax_from_state_dict(state)


@pytest.mark.parametrize("flip", [True, False])
def test_extract_embeddings_tta_matches_jax(golden18, flip, rng):
    model, jmodel, variables = golden18
    images = rng.uniform(-1, 1, (6, 112, 112, 3)).astype(np.float32)
    got = RT.extract_embeddings_tta(model, images, batch_size=4, use_flip_test=flip, device="cpu")
    want = JRT.extract_embeddings_tta(jmodel, variables, images, batch_size=4, use_flip_test=flip)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="parallelism slice"):
        RT.extract_embeddings_tta(model, images, mesh=object(), device="cpu")


def test_extract_features_partitioned_resumes(golden18, rng, tmp_path):
    model, jmodel, variables = golden18
    images = rng.uniform(-1, 1, (5, 112, 112, 3)).astype(np.float32)
    emb, norm = RT.extract_features_partitioned(model, lambda i: images[i], 5, num_partitions=3, batch_size=2,
                                                save_dir=str(tmp_path), device="cpu")
    assert emb.shape == (5, 512) and norm.shape == (5, 1)
    assert sorted(os.listdir(tmp_path)) == ["features_part0.npz", "features_part1.npz", "features_part2.npz"]
    jsave = tmp_path.parent / (tmp_path.name + "_jax")
    jemb, jnorm = JRT.extract_features_partitioned(jmodel, variables, lambda i: images[i], 5, num_partitions=3,
                                                   batch_size=2, save_dir=str(jsave))
    assert sorted(os.listdir(jsave)) == sorted(os.listdir(tmp_path))
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
    marker = np.full((2, 512), 7.0, np.float32)
    np.savez(tmp_path / "features_part1.npz", emb=marker, norm=np.ones((2, 1), np.float32))
    emb2, _ = RT.extract_features_partitioned(model, lambda i: images[i], 5, num_partitions=3, batch_size=2,
                                              save_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(emb2[2:4], marker)
    np.testing.assert_array_equal(emb2[[0, 1, 4]], emb[[0, 1, 4]])


def _write_bin(path, rng, n_pairs=10, size=112):
    bins = []
    for i in range(2 * n_pairs):
        buf = __import__("io").BytesIO()
        side = size if i % 7 else 100  # an off-size image, resized on load
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=90)
        bins.append(buf.getvalue())
    with open(path, "wb") as f:
        pickle.dump((bins, [bool(b) for b in rng.random(n_pairs) < 0.5]), f)


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("val")
    _write_bin(root / "lfw.bin", rng)
    _write_bin(root / "cfp_fp_src.bin", rng)
    os.rename(root / "cfp_fp_src.bin", root / "cfp_fp.bin")
    RCONV.bin_to_memfile(str(root / "cfp_fp.bin"), str(root))
    os.remove(root / "cfp_fp.bin")
    return root


def test_bin_and_memfile_loaders(val_dir):
    data, issame = D.load_bin_dataset(str(val_dir / "lfw.bin"))
    jdata, jissame = JD.load_bin_dataset(str(val_dir / "lfw.bin"))
    np.testing.assert_array_equal(issame, jissame)
    assert data.shape == jdata.shape == (20, 112, 112, 3)
    # PIL and cv2 decode the JPEGs alike; the off-size images go through
    # resize_np, cv2's INTER_LINEAR within 1 grey level.
    assert np.abs(data.astype(int) - jdata).max() <= 1
    sets = D.load_five_validation_sets(str(val_dir))
    assert sorted(sets) == ["cfp_fp", "lfw"]
    np.testing.assert_array_equal(sets["cfp_fp"][0], JD.get_val_pair_memfile(str(val_dir), "cfp_fp")[0])


def test_validate_5sets_on_a_partial_bundle(golden18, val_dir, tmp_path):
    model, jmodel, variables = golden18
    out = RT.validate_5sets(model, str(val_dir), batch_size=8, device="cpu")
    want = JRT.validate_5sets(jmodel, variables, str(val_dir), batch_size=8)
    assert sorted(out) == sorted(want) == ["cfp_fp", "lfw", "mean"]
    for name in ("cfp_fp", "lfw"):
        assert out[name] == pytest.approx(want[name], abs=1e-6)
    assert out["mean"]["val_acc"] == pytest.approx((out["lfw"]["val_acc"] + out["cfp_fp"]["val_acc"]) / 2)
    with pytest.raises(FileNotFoundError, match="no validation sets"):
        RT.validate_5sets(model, str(tmp_path), device="cpu")


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """An IR-18 in the reference's own module layout
    (tests/test_torch_convert_more.py::TIR18) with randomised BatchNorm
    statistics, saved as a .pth: the one weights file both packages'
    CLIs load."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        ref = TIR18().eval()
    _randomize_bn(ref)
    path = str(tmp_path_factory.mktemp("ref") / "ir18.pth")
    torch.save(ref.state_dict(), path)
    return ref, path


def test_pth_backbone_equals_the_reference_module(reference_pth, rng):
    ref, path = reference_pth
    model = build_model("ir_18", device="cpu").eval()
    model.load_state_dict(ir_state_dict_from_pth(load_pth(path), 18, "ir"))
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 112, 112)).astype(np.float32))
    with torch.no_grad():
        for got, want in zip(model(x), ref(x)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _image_files(root, rng):
    """PNGs and JPEGs at 112 and off-size (resized to 112 on load)."""
    os.makedirs(root)
    paths = []
    for i, (h, w, fmt) in enumerate([(112, 112, "PNG"), (90, 100, "PNG"), (112, 112, "JPEG"), (150, 131, "JPEG")]):
        rgb = chip_smoke.smooth_image(np.random.default_rng(40 + i), h, w)
        p = str(root / f"{i}.{fmt.lower()}")
        Image.fromarray(rgb).save(p, format=fmt, quality=90)
        paths.append(p)
    return paths


def test_load_images_matches_jax(golden18, tmp_path, rng):
    """The port's PIL decode + cv2-style resize + BGR -> RGB against the
    JAX package's cv2.imread + cv2.resize: equal at 112 (a channel swap
    would show here), within 1 grey level (2/255 after normalisation)
    where an image is resized. The resize rounds as float, cv2 in fixed
    point: 4,877 and 4,875 of the 37,632 values of the two resized images
    differ by 1 (observed), which moves their embeddings by up to 1.2e-3
    (cosine 0.99998); the bounds are 3e-3 and 0.999."""
    model, jmodel, variables = golden18
    paths = _image_files(tmp_path / "img", rng)
    got, want = RC._load_images(paths), JRC._load_images(paths)
    assert got.shape == want.shape == (4, 112, 112, 3)
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    assert np.abs(got - want).max() <= 2 / 255 + 1e-6
    assert (np.abs(got - want) > 1e-6).mean() < 0.25
    emb = RT.extract_embeddings_tta(model, got, 4, device="cpu")[0]
    jemb = JRT.extract_embeddings_tta(jmodel, variables, want, 4)[0]
    np.testing.assert_allclose(emb[[0, 2]], jemb[[0, 2]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=3e-3)
    assert (emb * jemb).sum(axis=1).min() > 0.999


MODEL = ["--arch", "ir_18", "--batch-size", "8", *CPU]


def test_cli_verify_tinyface_extract(reference_pth, val_dir, tmp_path, rng, capsys):
    """Both packages' CLIs on the same .pth and files. verify and
    tinyface give equal accuracies and ranks; extract's features agree
    within 1e-3 (one off-size probe is resized, within 1 grey level)."""
    args = ["--arch", "ir_18", "--batch-size", "8", "--ckpt", reference_pth[1]]

    def both(argv):
        outs = []
        for main, extra in ((RC.main, CPU), (JRC.main, [])):
            main([*argv, *args, *extra])
            outs.append(capsys.readouterr().out)
        return outs

    got, want = (json.loads(o) for o in both(["verify", "--data-dir", str(val_dir)]))
    assert sorted(got) == sorted(want) == ["cfp_fp", "lfw", "mean"]
    for name in got:
        assert got[name] == pytest.approx(want[name], abs=1e-6)
    root = _tinyface_tree(tmp_path / "tf", rng)
    got, want = (json.loads(o) for o in both(["tinyface", "--tinyface-root", str(root)]))
    assert sorted(got) == ["rank_1", "rank_20", "rank_5"] and got == want
    test = TF.TinyFaceTest(str(root))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(test.image_paths[:4]) + "\n")
    out_dir, jout_dir = tmp_path / "feats", tmp_path / "jfeats"
    RC.main(["extract", *args, *CPU, "--image-list", str(lst), "--out-dir", str(out_dir), "--partitions", "3"])
    JRC.main(["extract", *args, "--image-list", str(lst), "--out-dir", str(jout_dir), "--partitions", "3"])
    capsys.readouterr()
    z, jz = np.load(out_dir / "features.npz"), np.load(jout_dir / "features.npz")
    assert z["emb"].shape == (4, 512) and list(z["paths"]) == list(jz["paths"]) == test.image_paths[:4]
    assert len([n for n in os.listdir(out_dir) if n.startswith("features_part")]) == 2
    np.testing.assert_allclose(z["emb"], jz["emb"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(z["norm"], jz["norm"], rtol=1e-3)


@pytest.fixture(scope="module")
def artifact(golden18, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("emb_art"))
    RC.main(["export", *MODEL[:2], "--batch-size", "2", "--fold", "--platforms", "cpu", "--out", out, *CPU])
    return out


def test_export_loads_and_equals_live(artifact, rng):
    art = aot.load_exported(artifact, device="cpu")
    assert isinstance(art, aot.AotEmbedder) and art.batch_size == 2
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    live = RC._load_backbone(RC.build_parser().parse_args(["export", *MODEL[:2], "--fold", "--out", "x", *CPU]))
    with torch.no_grad():
        want = live(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = art.embed(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="artifact batch is 2"):
        art.embed(np.zeros((3, 112, 112, 3), np.float32))
    manifest = json.load(open(os.path.join(artifact, "manifest.json")))
    assert manifest["kind"] == "embedder" and manifest["model"] == "ir_18" and manifest["platforms"] == ["cpu"]


def test_embedder_artifact_matches_the_jax_artifact(golden18, tmp_path, rng):
    model, jmodel, variables = golden18
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    aot.export_embedder(model, str(tmp_path / "port"), batch_size=2)
    JAOT.export_embedder(jmodel, variables, str(tmp_path / "jax"), batch_size=2, platforms=("cpu",))
    got = aot.load_exported(str(tmp_path / "port"), device="cpu").embed(x)
    want = JAOT.load_exported(str(tmp_path / "jax")).embed(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_artifact_loads_in_a_fresh_interpreter_without_model_code(artifact):
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        from jabd_tpu_torch import aot
        art = aot.load_exported({artifact!r}, device="cpu")
        emb, norm = art.embed(np.zeros((2, 112, 112, 3), np.float32))
        assert tuple(emb.shape) == (2, 512)
        bad = sorted(m for m in sys.modules if m.startswith(("jabd_tpu_torch.recognition", "jabd_tpu_torch.models")))
        assert not bad, bad
        """
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
