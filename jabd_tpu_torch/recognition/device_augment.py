"""AdaFace's training augmentation on the card.

Port of `jabd_tpu/recognition/device_augment.py`. Every operation of the
recipe (data.py:217-260) is linear or elementwise:

  * the crop is a rank-1 mask (row and column indicators);
  * the low-res down-up resample is one [S, S] linear map per axis: the
    1-D operators of cv2.resize composed on the host
    (`cv2_resize_matrix`), with the flip folded into the horizontal one;
  * ColorJitter and the [-1, 1] normalization are elementwise with
    per-sample scalars ((1, 1, 1) leaves a sample as it is).

So the host decodes and draws (`draw_face_augment_params`, the host
loader's RNG streams), and the card applies mask -> Mv . x . Mh^T per
sample (two batched matmuls) -> round and clip (cv2's uint8 cast) ->
ColorJitter -> normalize, inside the train step.

`cv2_resize_matrix` builds cv2's operators from its rules, without cv2:
NEAREST's floor(d * (1 / (dsize / ssize))) in double; LINEAR and CUBIC at
half-pixel centres with border rows clamped (several taps may land on one
source row); LANCZOS4's 8 taps normalized to sum 1; AREA's box weights on
a downscale (its block mean when the ratio is an integer) and its linear
weights on an upscale. The JAX package extracts the same operators by
resizing an identity matrix with cv2; the tests hold all 900 that the
draw can produce to within 1e-5 of those.

The ColorJitter runs in float64 with the drawn factors, the host's
arithmetic, and the contrast anchor is the exact integer
floor((2 * sum + N) / (2 * N)) of the grey image's sum, which is the
host's int(mean + 0.5) for every sum: without a low-res draw the card's
pixels are the host's, byte for byte. With one they differ by the host's
intermediate uint8 rounding, which the composed float operator skips.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from jabd_tpu_torch.ops.resize import separable_resample
from jabd_tpu_torch.recognition import data as D


class FaceAugmentPlan(NamedTuple):
    """A batch's augmentation program (torch tensors, built on the host).

    mv, mh:      [B, S, S] per-sample resample operators (flip folded in mh)
    keep_v:      [B, S] 1.0 on the rows the crop keeps (all ones: no crop)
    keep_h:      [B, S] the columns the crop keeps
    photo:       [B, 3] float64 (brightness, contrast, saturation); (1, 1, 1): off
    photo_order: [B, 3] int64 ColorJitter op order (0 b, 1 c, 2 s)
    """

    mv: torch.Tensor
    mh: torch.Tensor
    keep_v: torch.Tensor
    keep_h: torch.Tensor
    photo: torch.Tensor
    photo_order: torch.Tensor


def _cubic_coeffs(x: float):
    """cv2's interpolateCubic (A = -0.75) at offset x, in double."""
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return [c0, c1, c2, 1 - c0 - c1 - c2]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_coeffs(x: np.float32):
    """cv2's interpolateLanczos4 at offset x: 8 float32 taps scaled to sum
    1 (the tap at distance 0 set to 1e30 before the scaling)."""
    f32 = np.float32
    y0 = -(float(x) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = []
    total = f32(0)
    for i, (cs_s, cs_c) in enumerate(_LANCZOS_CS):
        d = f32(x + f32(3 - i))
        if abs(d) >= f32(1e-6):
            y = -float(d) * math.pi * 0.25
            c = f32((cs_s * s0 + cs_c * c0) / (y * y))
        else:
            c = f32(1e30)
        coeffs.append(c)
        total = f32(total + c)
    inv = f32(f32(1) / total)
    return [f32(c * inv) for c in coeffs]


def _area_down(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """cv2's INTER_AREA downscale weights (computeResizeAreaTab), or the
    block mean when `scale` is an integer (resizeAreaFast)."""
    m = np.zeros((out_size, in_size), np.float32)
    iscale = int(round(scale))
    if abs(scale - iscale) < np.finfo(np.float64).eps:
        for d in range(out_size):
            m[d, d * iscale : min((d + 1) * iscale, in_size)] = np.float32(1) / np.float32(iscale)
        return m
    for d in range(out_size):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, in_size - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, in_size - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[d, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[d, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[d, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


@functools.lru_cache(maxsize=1024)
def cv2_resize_matrix(in_size: int, out_size: int, interp: int) -> np.ndarray:
    """[out_size, in_size] float32 operator of cv2.resize along one axis for
    cv2 mode `interp` (0 NEAREST, 1 LINEAR, 2 CUBIC, 3 AREA, 4 LANCZOS4):
    the rows of the resized identity matrix."""
    f32 = np.float32
    if in_size == out_size:
        return np.eye(in_size, dtype=f32)
    inv_scale = out_size / in_size
    scale = 1.0 / inv_scale
    m = np.zeros((out_size, in_size), f32)
    if interp == 0:
        for d in range(out_size):
            m[d, min(math.floor(d * scale), in_size - 1)] = 1.0
        return m
    if interp == 3 and scale >= 1:
        return _area_down(in_size, out_size, scale)
    if interp not in (1, 2, 3, 4):
        raise ValueError(f"unknown cv2 interpolation {interp}")
    ksize = {1: 2, 3: 2, 2: 4, 4: 8}[interp]
    for d in range(out_size):
        if interp == 3:  # an AREA upscale: linear taps at cell edges
            s = math.floor(d * scale)
            fy = f32((d + 1) - (s + 1) * inv_scale)
            fy = f32(0) if fy <= 0 else f32(fy - f32(math.floor(fy)))
        elif interp == 4:  # LANCZOS4 takes its offset in float32
            fy = f32((d + 0.5) * scale - 0.5)
            s = math.floor(fy)
            fy = f32(fy - f32(s))
        else:
            src = (d + 0.5) * scale - 0.5
            s = math.floor(src)
            fy = f32(src - s)
        if interp == 2:
            taps = [f32(c) for c in _cubic_coeffs(float(fy))]
        elif interp == 4:
            taps = _lanczos4_coeffs(fy)
        else:
            taps = [f32(f32(1) - fy), fy]
        for k, wk in enumerate(taps):  # border rows replicated
            src_row = min(max(s - ksize // 2 + 1 + k, 0), in_size - 1)
            m[d, src_row] = f32(m[d, src_row] + wk)
    return m


@functools.lru_cache(maxsize=64)
def _eye(size: int) -> np.ndarray:
    return np.eye(size, dtype=np.float32)


def plan_face_sample(draw: "D.FaceAugmentDraw", flip: bool, size: int = 112):
    """One drawn augmentation and the loader's flip as plan parts (mv, mh,
    keep_v, keep_h, photo, order), numpy."""
    if draw.lowres is not None:
        small, down, up = draw.lowres
        m = cv2_resize_matrix(small, size, up) @ cv2_resize_matrix(size, small, down)
    else:
        m = _eye(size)
    # The flip follows the (spatially uniform) jitter and commutes with
    # it: fold it into the horizontal operator.
    mh = m[::-1] if flip else m
    keep_v = np.ones(size, np.float32)
    keep_h = np.ones(size, np.float32)
    if draw.crop is not None:
        i, ch, j, cw = draw.crop
        keep_v = np.zeros(size, np.float32)
        keep_v[i : i + ch] = 1.0
        keep_h = np.zeros(size, np.float32)
        keep_h[j : j + cw] = 1.0
    photo = np.asarray(draw.photo or (1.0, 1.0, 1.0), np.float64)
    order = np.asarray(draw.photo_order, np.int64)
    return m, mh, keep_v, keep_h, photo, order


def stack_face_plans(parts: Sequence[Tuple], matrix_dtype: torch.dtype = torch.float32) -> FaceAugmentPlan:
    """Per-sample plan parts -> one FaceAugmentPlan of CPU tensors. The
    loader ships bfloat16 operators (the card resamples in bf16); parity
    checks keep float32."""

    def stacked(arrays):
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrays)))

    mv, mh, kv, kh, photo, order = zip(*parts)
    return FaceAugmentPlan(
        mv=stacked(mv).to(matrix_dtype), mh=stacked(mh).to(matrix_dtype), keep_v=stacked(kv),
        keep_h=stacked(kh), photo=stacked(photo), photo_order=stacked(order),
    )


def contrast_anchor(gray: torch.Tensor) -> torch.Tensor:
    """[B, ...] integer-valued grey images -> [B] int64 rounded means, exact:
    floor((2 * sum + N) / (2 * N)), which is PIL's (and the host's)
    int(mean + 0.5) for every sum. A float32 mean can round a sum just
    below a half-way point up to it."""
    n = gray[0].numel()
    total = gray.flatten(1).sum(1, dtype=torch.float64).round().long()
    return torch.div(2 * total + n, 2 * n, rounding_mode="floor")


def _gray(y):
    """PIL's L conversion of integer-valued RGB, exact in float64."""
    return torch.floor((y[..., 0:1] * 19595.0 + y[..., 1:2] * 38470.0 + y[..., 2:3] * 7471.0 + 32768.0) / 65536.0)


def _blend(degenerate, y, factor):
    return torch.trunc(degenerate + factor * (y - degenerate)).clamp(0.0, 255.0)


def device_augment_faces(
    images_u8: torch.Tensor,  # [B, S, S, 3] uint8
    plan: FaceAugmentPlan,  # on the images' device
    resample_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 faces + plan -> float32 [B, S, S, 3] in [-1, 1]: what
    `augment_face`, the flip and `normalize_face` make on the host, up to
    the resample's rounding on low-res draws. In order: crop mask ->
    resample (two batched matmuls in `resample_dtype`; float32 is full
    float32 on the card only with TF32 off) -> round and clip -> the three
    jitter ops in each sample's order (float64) -> normalize."""
    rdt = resample_dtype
    mask = (plan.keep_v.to(rdt)[:, :, None] * plan.keep_h.to(rdt)[:, None, :])[..., None]
    x = images_u8.to(rdt) * mask
    y = separable_resample(x, plan.mv, plan.mh, rdt, clip_between=False)
    y = torch.round(y.float()).clamp_(0.0, 255.0).double()

    photo = plan.photo.to(torch.float64)
    b, c, s = (photo[:, i].view(-1, 1, 1, 1) for i in range(3))
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    for k in range(3):
        op = plan.photo_order[:, k].view(-1, 1, 1, 1)
        g = _gray(y)
        y_b = _blend(zero, y, b)
        y_c = _blend(contrast_anchor(g).to(y.dtype).view(-1, 1, 1, 1), y, c)
        y_s = _blend(g, y, s)
        y = torch.where(op == 0, y_b, torch.where(op == 1, y_c, y_s))
    # normalize_face's float32 operations in its order; the divisors are
    # tensors (CUDA multiplies by the reciprocal of a Python scalar).
    x = y.float()
    x = x / torch.full((), 255.0, device=x.device)
    x = x - 0.5
    return x / torch.full((), 0.5, device=x.device)


def device_face_train_loader(
    dataset: "D.ImageFolderDataset",
    batch_size: int,
    seed: int = 0,
    num_workers: int = 8,
    drop_last: bool = True,
    matrix_dtype: torch.dtype = torch.bfloat16,
):
    """Device-augmentation twin of `data.recognition_train_loader`: yields
    (images_u8 [B, S, S, 3] numpy uint8, FaceAugmentPlan of CPU tensors,
    labels [B] numpy int32). The host decodes (and resizes an off-size
    source); each sample's RNG stream is the host loader's, so the plans
    are the host loader's augmentations."""
    size = dataset.output_size

    def fetch(idx):
        img, label = dataset.load(int(idx))
        rng = D.sample_rng(seed, idx)
        draw = D.draw_face_augment_params(
            rng, size, size, dataset.crop_prob, dataset.low_res_prob, dataset.photometric_prob
        )
        flip = rng.random() < 0.5  # RandomHorizontalFlip
        return img, plan_face_sample(draw, flip, size), label

    pool = cf.ThreadPoolExecutor(max_workers=num_workers)
    try:
        for idxs in D.epoch_order(len(dataset), batch_size, seed, drop_last):
            results = list(pool.map(fetch, idxs))
            images = np.stack([r[0] for r in results])
            plan = stack_face_plans([r[1] for r in results], matrix_dtype=matrix_dtype)
            labels = np.asarray([r[2] for r in results], np.int32)
            yield images, plan, labels
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
