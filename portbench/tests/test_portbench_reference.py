"""The reference against the served package's CPU paths at a tiny size,
and the detection comparison on hand-made cases."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generators as G
from portbench.reference import detect as RD
from portbench.reference import train as RT
from portbench.reference.model import RetinaFace

REPO = Path(__file__).resolve().parents[2]

CONFIGS = ("jabd_flagship", "re50_eca_nonlocal")


def config(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def seeded(name, mode, seed=3, size=96):
    ref = RetinaFace(config(name)["model"], mode)
    G.seed_weights(ref, G.torch_gen(seed, 3, "cpu"))
    x = 40 * torch.randn((4, 3, size, size), generator=torch.Generator().manual_seed(seed))
    G.calibrate_batchnorms(ref, x)
    return ref, x


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_reference_model_equals_the_served_model_in_float32(name, mode):
    from jabd_tpu_torch import configs as C
    from jabd_tpu_torch.models import build_model

    ref, x = seeded(name, mode)
    port = build_model(C.get_model_config(name), mode=mode, device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.train(mode == "train")
    port.train(mode == "train")
    with torch.no_grad():
        for a, b in zip(ref(x), port(x)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_loss_and_gradient_equal_the_served_loss(name):
    from jabd_tpu_torch import losses as L

    cfg = config(name)
    traffic = {"batch": 3, "image_size": 96, "max_targets": 6, "pool_batches": 1, "source_width": 200,
               "faces_per_image": 3.0, "face_px": [10.0, 150.0], "landmark_share": 0.7}
    images, targets = G.train_pool(traffic, 5, "cpu")[0]
    priors = RD.anchors(cfg["model"]["anchors"], (96, 96))
    ref, _ = seeded(name, "train")
    ref.train()
    out = ref(images.permute(0, 3, 1, 2))
    want = RT.multibox_loss(out, targets, priors, cfg["train"], (0.1, 0.2))
    parts = L.multibox_loss(out, priors, L.Targets(*targets), overlap_threshold=0.35, neg_pos_ratio=7)
    got = L.total_loss(parts, 2.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ga = torch.autograd.grad(want, out[0], retain_graph=True)[0]
    gb = torch.autograd.grad(got, out[0])[0]
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-7)


def test_reference_anchors_and_letterbox_equal_the_served_ones():
    from jabd_tpu_torch import configs as C
    from jabd_tpu_torch.ops import anchors as A
    from jabd_tpu_torch.ops import image as I

    cfg = config("jabd_flagship")
    for size in ((96, 96), (100, 72)):
        want = torch.from_numpy(A.generate_anchors(C.get_model_config("jabd_flagship").anchors, size).copy())
        assert torch.equal(RD.anchors(cfg["model"]["anchors"], size), want)
    rng = np.random.default_rng(0)
    for shape in ((60, 80, 3), (90, 40, 3)):
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        want = I.preprocess_input_np(I.letterbox_np(im, (96, 96)))
        got = RD.letterbox(im, (96, 96), "cpu").permute(1, 2, 0).numpy()
        np.testing.assert_array_equal(got, want)


def _rows(boxes, scores):
    """[N, 15] rows: boxes, scores, landmarks at the box centres."""
    n = len(boxes)
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    return torch.cat([boxes, scores[:, None], c.repeat(1, 5)], 1)


def compare(served, ref, setting):
    c = RD.Comparison(setting)
    c.add([served], [ref])
    return c.raw()


def test_the_comparison_reads_zero_for_the_greedy_nms_and_catches_its_faults():
    g = torch.Generator().manual_seed(1)
    xy = 100 * torch.rand((400, 2), generator=g)
    boxes = torch.cat([xy, xy + 5 + 20 * torch.rand((400, 2), generator=g)], 1)
    scores = 0.1 + 0.8 * torch.rand(400, generator=g)
    ref = _rows(boxes, scores)
    order = torch.argsort(-scores, stable=True)
    keep = RD.greedy_keep(boxes[order][None], torch.ones(1, 400, dtype=torch.bool), 0.3)[0]
    served = ref[order][keep].numpy()
    n = len(served)
    setting = {"nms_iou": 0.3, "confidence": 0.02, "max_detections": 750, "pre_nms_topk": 400}
    assert compare(served, ref, setting) == {"box_gap_px": 0.0, "score_gap": 0.0, "nms_overlap": 0.0,
                                             "nms_missed": 0.0}
    # Cut to the best 10 with max_detections 10: still exact.
    assert compare(served[:10], ref, {**setting, "max_detections": 10})["nms_missed"] == 0.0
    # ... but 10 of n with room for 750 misses the other n - 10 kept rows
    # and what only they suppress.
    assert compare(served[:10], ref, setting)["nms_missed"] >= (n - 10) / 10
    # The same with a pre-NMS top-k that cuts below the 10th kept row.
    top = int(torch.nonzero(keep).flatten()[9]) + 1
    assert compare(served[:10], ref, {**setting, "pre_nms_topk": top})["nms_missed"] == 0.0
    # No suppression at all: overlapping rows are served.
    assert compare(ref[order][:200].numpy(), ref, setting)["nms_overlap"] > 0.1
    # Row 0 moved by 3 px and row 1's score raised by 0.05.
    bad = served.copy()
    bad[0, 0] += 3.0
    bad[1, 4] += 0.05
    got = compare(bad, ref, setting)
    assert abs(got["box_gap_px"] - 3.0 / n) < 1e-5 and abs(got["score_gap"] - 0.05 / n) < 1e-6
    # Nothing served: every candidate above the confidence is missed.
    assert compare(served[:0], ref, setting)["nms_missed"] == 400.0
    # The reference in the program's place serves the same rows.
    assert compare(served, ref, setting) == compare(served.copy(), ref, setting)


def test_reference_detect_serves_the_greedy_nms_of_its_candidates():
    cfg = config("jabd_flagship")
    ref, _ = seeded("jabd_flagship", "eval", size=128)
    ref.eval()
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 100, 3), dtype=np.uint8)]
    priors = RD.anchors(cfg["model"]["anchors"], (128, 128))
    setting = {"nms_iou": 0.3, "confidence": 0.02, "max_detections": 40, "pre_nms_topk": 300}
    served = RD.reference_detect(ref, images, (128, 128), priors, (0.1, 0.2), setting, "cpu")
    rows = RD.reference_rows(ref, images, (128, 128), priors, (0.1, 0.2), "cpu")
    c = RD.Comparison(setting)
    c.add(served, rows)
    assert c.raw() == {"box_gap_px": 0.0, "score_gap": 0.0, "nms_overlap": 0.0, "nms_missed": 0.0}
    assert [len(s) for s in served] == [40, 40]
    # In plain bfloat16 the reference departs from itself; the served rows
    # read in units of that departure.
    yard = RD.Comparison(setting)
    yard.add(RD.reference_detect(ref, images, (128, 128), priors, (0.1, 0.2), setting, "cpu", "bfloat16"), rows)
    assert yard.raw()["box_gap_px"] > 0.0
    got = RD.ratios(c, yard)
    assert set(got) == {"box_gap", "score_gap", "nms_overlap", "nms_missed"} and got["box_gap"] == 0.0


def test_fp8_rounding_keeps_three_mantissa_bits_and_two_in_the_gradient():
    from portbench.reference.model import fp8_round

    x = torch.tensor([448.0, 1.0, 1.1, -3.3], requires_grad=True)
    y = fp8_round(x)
    assert y.tolist() == [448.0, 1.0, 1.125, -3.25]
    y.backward(torch.tensor([57344.0, 1.0, 1.1, -3.3]))
    assert x.grad.tolist() == [57344.0, 1.0, 1.0, -3.5]
