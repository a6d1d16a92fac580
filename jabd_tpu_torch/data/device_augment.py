"""Training augmentation on the card: a batched resample and the HSV
jitter as tensor ops.

Port of `jabd_tpu/data/device_augment.py`. The reference's
`get_random_data` (utils/dataloader.py:71-149) runs per sample on host
workers: PIL bicubic resize onto a grey canvas, flip, float HSV jitter.
Every pixel operation of that recipe is linear or elementwise, so here:

  * the host draws the random parameters (`wider.draw_augment_params`, the
    same RNG consumption as the host path) and builds per sample and axis
    the taps of a PIL-bicubic resize composed with the paste offset and the
    flip (`ops/resize.paste_resize_taps`). Box geometry goes through
    `wider.transform_boxes`, so the targets are byte-identical to the host
    loader's;
  * the card rebuilds the dense [S, bucket] matrices (`expand_taps`), runs
    out = Mv @ image @ Mh^T per sample as two batched matmuls over a uint8
    batch padded to a static bucket, adds the 128 grey fill outside the
    paste, and applies cv2's float HSV jitter and the mean subtraction.

Pixels differ from the host path by resample rounding only (PIL rounds to
uint8 between its two fixed-point passes); the bounds are in
tests/test_torch_port_augment.py. The host's share is decode, the
pre-shrink of a source larger than the bucket, pad and the O(S * K) taps.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from jabd_tpu_torch.data import wider
from jabd_tpu_torch.ops.image import MEANS, hsv_jitter, pil_bicubic_resize
from jabd_tpu_torch.ops.resize import TAPS_FSCAP, expand_taps, paste_resize_taps, resample_canvas


class AugmentPlanTaps(NamedTuple):
    """A batch's augmentation plan (torch tensors): per canvas row or
    column the first source tap and TAPS_K weights of the resample, which
    the card expands to dense [S, bucket] matrices (`expand_taps`), bucket
    / TAPS_K times fewer bytes to copy than the matrices.

    xmin_v/h: [B, S] int32 first-tap index per canvas row/col
    w_v/h:    [B, S, TAPS_K] tap weights (flip folded in h)
    inside_v: [B, S] 1.0 where the paste covers the canvas row
    inside_h: [B, S] 1.0 where the paste covers the canvas column
    hsv:      [B, 3] (dh*360, ds, dv) jitter parameters
    """

    xmin_v: torch.Tensor
    w_v: torch.Tensor
    xmin_h: torch.Tensor
    w_h: torch.Tensor
    inside_v: torch.Tensor
    inside_h: torch.Tensor
    hsv: torch.Tensor


def plan_sample(
    image_u8: np.ndarray,  # [ih, iw, 3] uint8 (decoded, unpadded)
    box: np.ndarray,  # [N, 15]
    input_size: int,
    rng: np.random.Generator,
    bucket_hw: Tuple[int, int],
    jitter: float = 0.3,
    hue: float = 0.1,
    sat: float = 1.5,
    val: float = 1.5,
):
    """Draw one augmentation and compile it to resample taps.

    Returns (padded_u8 [bh, bw, 3], plan parts (xmin_v, w_v, xmin_h, w_h,
    inside_v, inside_h, hsv), boxes [M, 15]). Boxes are byte-identical to
    `wider.augment_sample` under the same rng. A source larger than the
    bucket is pre-shrunk to it (PIL bicubic, `pil_bicubic_resize`), and so
    is any axis whose downscale factor exceeds TAPS_FSCAP (pixels only):
    every tap window then fits TAPS_K.
    """
    ih, iw = image_u8.shape[:2]
    draw = wider.draw_augment_params(rng, input_size, jitter, hue, sat, val)
    boxes = wider.transform_boxes(box, draw, (iw, ih), input_size, rng)

    bh, bw = bucket_hw
    th = min(ih, bh, int(TAPS_FSCAP * max(draw.nh, 1)))
    tw = min(iw, bw, int(TAPS_FSCAP * max(draw.nw, 1)))
    if (th, tw) != (ih, iw):
        image_u8 = pil_bicubic_resize(image_u8, (tw, th))
        ih, iw = th, tw
    # The margins are never read with a nonzero weight: no zero fill.
    padded = np.empty((bh, bw, 3), np.uint8)
    padded[:ih, :iw] = image_u8

    s = input_size
    hsv = np.asarray([draw.dh * 360.0, draw.ds, draw.dv], np.float32)
    xv, wv, inside_v = paste_resize_taps(ih, draw.nh, draw.dy, s)
    xh, wh, inside_h = paste_resize_taps(iw, draw.nw, draw.dx, s, flip=draw.flip)
    return padded, (xv, wv, xh, wh, inside_v, inside_h, hsv), boxes


def stack_plans(parts: Sequence[Tuple], weight_dtype: torch.dtype = torch.float32) -> AugmentPlanTaps:
    """Stack per-sample plan tuples into one AugmentPlanTaps of CPU
    tensors. `weight_dtype` is the storage type of the tap weights: the
    loader ships torch.bfloat16 (half the bytes; the bf16 resample casts to
    it anyway), parity checks float32."""

    def stacked(arrays):
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrays)))

    xv, wv, xh, wh, iv, ih_, hsv = zip(*parts)
    return AugmentPlanTaps(
        xmin_v=stacked(xv),
        w_v=stacked(wv).to(weight_dtype),
        xmin_h=stacked(xh),
        w_h=stacked(wh).to(weight_dtype),
        inside_v=stacked(iv),
        inside_h=stacked(ih_),
        hsv=stacked(hsv),
    )


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def device_augment(
    images_u8: torch.Tensor,  # [B, bucket_h, bucket_w, 3] uint8
    plan: AugmentPlanTaps,  # on the images' device
    resample_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Padded uint8 sources + plan -> mean-subtracted float32 [B, S, S, 3]
    training frames: the tensor `wider.augment_sample` +
    `preprocess_input_np` make, up to resample rounding.

    resample_dtype=bfloat16 runs the two contractions on the tensor cores
    (uint8 values are exact in bf16, tap weights round to ~3 digits);
    float32 is for parity checks."""
    bh, bw = images_u8.shape[1], images_u8.shape[2]
    mv = expand_taps(plan.xmin_v, plan.w_v, bh, resample_dtype)
    mh = expand_taps(plan.xmin_h, plan.w_h, bw, resample_dtype)
    y = resample_canvas(
        images_u8, mv, mh, plan.inside_v, plan.inside_h,
        fill=128.0, resample_dtype=resample_dtype,
    )
    jitter = [plan.hsv[:, i][:, None, None] for i in range(3)]
    rgb = hsv_jitter(y, *jitter)
    return (rgb - torch.tensor(MEANS, dtype=torch.float32, device=rgb.device)).contiguous()


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def device_train_loader(
    dataset: "wider.WiderFaceDataset",
    batch_size: int,
    bucket_hw: Tuple[int, int] = (1024, 1024),
    max_targets: int = 128,
    seed: int = 0,
    num_workers: int = 8,
    drop_last: bool = True,
):
    """Device-augmentation twin of `wider.train_loader`: yields (images_u8
    [B, bh, bw, 3] numpy uint8, AugmentPlanTaps of CPU tensors with bf16
    weights, padded targets). The
    host decodes (`dataset.load_image`), pre-shrinks where needed, pads and
    builds the taps, one sample per worker thread (each sample has its own
    RNG stream, so the order of work changes nothing); samples that lose
    every box re-draw their plan (no pixel work) and the batch is
    backfilled as the host loader does."""
    pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def make(idx, raw, attempt=0):
        # The host loader's per-(sample, attempt) stream: identical targets.
        return plan_sample(
            raw, dataset.annos[int(idx)], dataset.input_size,
            wider.sample_rng(seed, idx, attempt), bucket_hw,
        )

    def load_and_make(idx):
        raw = dataset.load_image(int(idx))
        return raw, make(idx, raw)

    try:
        for idxs in wider.epoch_batches(len(dataset), batch_size, seed, drop_last):
            loaded = list(pool.map(load_and_make, idxs))
            raws = {int(idx): raw for idx, (raw, _) in zip(idxs, loaded)}
            results = wider.backfill_batch(
                idxs,
                [plan for _, plan in loaded],
                lambda idx, attempt: make(idx, raws[int(idx)], attempt),
                lambda r: len(r[2]) == 0,
                batch_size,
            )
            if not results:
                continue
            images = np.stack([r[0] for r in results])
            plan = stack_plans([r[1] for r in results], weight_dtype=torch.bfloat16)
            tgts = wider.batch_targets([r[2] for r in results], max_targets)
            yield images, plan, tgts
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
