"""PyTorch port, the device-augment train step and `fit`'s two loaders on
the CPU at float32: jabd_flagship at 64x64, bucket 128x128, batch 2.

The step (uint8 sources and a bf16 taps plan in, `device_augment` with
its bf16 resample, then the train step) against the JAX package's
`aug_step` (Pallas matching in interpret mode); `fit` with
`device_augment=True`, with the host loader over a directory of PNGs, and
with every option at once."""

import ml_dtypes
import numpy as np
import pytest
import torch

from jabd_tpu.data import device_augment as JDA
from jabd_tpu_torch import configs as TC
from jabd_tpu_torch import step as ST
from jabd_tpu_torch import train as TT
from jabd_tpu_torch.data import device_augment as TDA
from jabd_tpu_torch.data import wider as TW
from jabd_tpu_torch.utils.checkpoint import CheckpointManager
from tests import _torch_port_steps as S
from tests._torch_port_steps import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_augment import _png_dataset, _sample_boxes, _smooth_image

SIZE = 64
BUCKET = (128, 128)
KW = dict(batch_size=2, image_size=SIZE, max_targets=4, device_augment=True, augment_bucket=BUCKET)


def _augment_inputs(seed=0, bsz=2):
    """Padded uint8 sources, the bf16 plans of both packages (the same
    parts) and padded targets: what device_train_loader yields."""
    padded, parts, boxes = [], [], []
    for i in range(bsz):
        rng = np.random.default_rng(seed + i)
        h, w = (100, 120) if i % 2 else (150, 90)
        img = _smooth_image(rng, h, w)
        box0 = _sample_boxes(rng, w, h, n=5)
        for attempt in range(8):  # re-draw until a box survives
            p, pa, b = TDA.plan_sample(img, box0.copy(), SIZE, TW.sample_rng(seed, i, attempt), BUCKET)
            if len(b):
                break
        padded.append(p)
        parts.append(pa)
        boxes.append(b)
    images = np.stack(padded)
    targets = TW.batch_targets(boxes, 4)
    return images, TDA.stack_plans(parts, torch.bfloat16), JDA.stack_plans(parts, ml_dtypes.bfloat16), targets


def test_device_augment_step_matches_jax_aug_step():
    variables = S.variables_for(SIZE)
    anchors = S.anchors_for(SIZE)
    images, plan_t, plan_j, targets = _augment_inputs()
    assert int(targets[3].sum()) > 0
    want = S.jax_step(dict(KW, matching_impl="pallas_interpret"), variables, (images, plan_j), targets, anchors)
    got = S.port_step(KW, variables, (torch.from_numpy(images), plan_t), targets, anchors)
    # The frames agree within 1.2e-4 (XLA fuses the HSV chain in the jitted
    # step); a BatchNorm mean near 0 then moves 1.1e-5 (observed); stated
    # 3e-5 absolute for the statistics, the plain step's tolerances else.
    S.assert_port_matches_jax(got, want, stats_atol=3e-5)
    # The same step on the frames device_augment makes (bf16 resample).
    frames = TDA.device_augment(torch.from_numpy(images), plan_t)
    plain = S.port_step(dict(KW, device_augment=False), variables, (frames,), targets, anchors)
    S.assert_ports_identical(got, plain)


@pytest.mark.parametrize("mb,remat", [(2, False), (2, True)])
def test_device_augment_step_with_microbatches_and_remat(mb, remat):
    """Each chunk augments its own slice: the same as augmenting the batch
    first, since device_augment works per sample."""
    variables = S.variables_for(SIZE)
    anchors = S.anchors_for(SIZE)
    images, plan_t, _, targets = _augment_inputs(seed=4)
    kw = dict(KW, microbatches=mb, remat=remat)
    got = S.port_step(kw, variables, (torch.from_numpy(images), plan_t), targets, anchors)
    frames = TDA.device_augment(torch.from_numpy(images), plan_t)
    want = S.port_step(dict(kw, device_augment=False, remat=False), variables, (frames,), targets, anchors)
    S.assert_ports_identical(got, want)


def _fit(tmp_path, dataset, **kw):
    cfg = S.model_cfgs()[1]
    tcfg = TC.TrainConfig(**{**dict(batch_size=2, image_size=SIZE, max_targets=4, freeze_epochs=1,
                                    total_epochs=2, save_period=1), **kw})
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = TT.fit(cfg, tcfg, dataset, log_dir=str(tmp_path / "logs"), checkpoint_manager=mgr, device="cpu")
    rows = (tmp_path / "logs" / "metrics.csv").read_text().splitlines()
    return state, mgr, rows


@pytest.mark.parametrize("options", [
    dict(device_augment=True, augment_bucket=BUCKET),
    dict(),
    dict(device_augment=True, augment_bucket=BUCKET, microbatches=2, remat=True),
])
def test_fit_on_a_wider_directory(tmp_path, options):
    """Two epochs across the freeze boundary over 4 PNGs: checkpoints 1 and
    2, two metrics.csv rows of finite losses, the loss txt file."""
    ds = TW.WiderFaceDataset(_png_dataset(tmp_path, n=4), input_size=SIZE)
    state, mgr, rows = _fit(tmp_path, ds, **options)
    assert mgr.all_steps() == [1, 2] and state.step == 4
    assert rows[0] == "epoch,step,loss,loss_l,loss_c,loss_landm,lr" and len(rows) == 3
    assert all(np.isfinite([float(v) for v in r.split(",")[2:6]]).all() for r in rows[1:])
    assert [int(r.split(",")[1]) for r in rows[1:]] == [2, 4]
    history = list((tmp_path / "logs").glob("loss_*/epoch_loss.txt"))
    assert len(history) == 1 and len(history[0].read_text().split()) == 2


def test_prefetch_to_device_keeps_order_and_structure():
    plan = TDA.AugmentPlanTaps(*(torch.full((2, 3), float(i)) for i in range(7)))
    batches = [(torch.full((2,), float(i)), plan if i % 2 else None, torch.zeros(1)) for i in range(5)]
    got = list(ST.prefetch_to_device(iter(batches), "cpu", depth=2))
    assert len(got) == 5
    for i, (x, p, z) in enumerate(got):
        assert torch.equal(x, batches[i][0]) and z.shape == (1,)
        assert (p is None) == (i % 2 == 0)
        if p is not None:
            assert isinstance(p, TDA.AugmentPlanTaps) and torch.equal(p.hsv, plan.hsv)
    with pytest.raises(TypeError):
        list(ST.prefetch_to_device(iter([("not a tensor",)]), "cpu"))
