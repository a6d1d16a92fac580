"""Image front end: letterbox + mean subtraction, without cv2.

Port of `jabd_tpu/ops/image.py` (`preprocess_input_np`,
`serving_front_end`, `letterbox_np`, `letterbox_params`,
`correct_boxes_scale_offset`, and `undo_letterbox_pixels` of
`jabd_tpu/predict.py`); `pil_bicubic_resize`, the uint8
`PIL.Image.resize(..., Image.BICUBIC)` that the JAX package's training
augmentation calls, in numpy; and the training augmentation's HSV jitter
in cv2's float HSV space (`hsv_jitter`), the one definition that the host
(`data/wider.augment_sample`) and the card (`data/device_augment`) both
run; the batched device letterbox (`plan_letterbox`,
`letterbox_batch_device`), the image pyramid (`plan_pyramid`,
`pyramid_batch_device`) and the pyramid's host pre-scale
(`cubic_resize_np`, cv2's float32 INTER_CUBIC). The JAX package letterboxes with
`cv2.resize`; cv2 is not a dependency of the port, so the resize here is
torch bilinear with half-pixel centres and clamped edge taps, which is
cv2's INTER_LINEAR (and, at an exact 2x downscale, equals the INTER_AREA
cv2 switches to). A uint8 image is rounded back to whole grey levels
after the resize and BEFORE the float conversion and the mean
subtraction, as the reference does. cv2 computes uint8 resizes in fixed
point, so the two agree to within 1 grey level.
"""

from __future__ import annotations

from typing import Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from jabd_tpu_torch.ops import resize as R
from jabd_tpu_torch.ops.resize import _pil_bicubic_filter

MEANS = (104.0, 117.0, 123.0)
LETTERBOX_FILL = 84.0  # the reference letterbox's grey (not 128)


def preprocess_input_np(image: np.ndarray) -> np.ndarray:
    """Subtract the channel means."""
    return image - np.asarray(MEANS, dtype=np.float32)


def rgb_to_hsv_cv2(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2HSV float semantics: rgb in [0,1] -> (H in [0,360],
    S, V in [0,1]), as OpenCV's RGB2HSV_f (FLT_EPSILON-guarded divisions,
    channel-priority tie-breaks)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    eps = float(np.finfo(np.float32).eps)
    s = diff / (v.abs() + eps)
    k = 60.0 / (diff + eps)
    h = torch.where(
        v == r,
        (g - b) * k,
        torch.where(v == g, (b - r) * k + 120.0, (r - g) * k + 240.0),
    )
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_cv2(hsv: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_HSV2RGB float semantics: (H [0,360], S, V [0,1]) -> rgb in
    [0,1] (OpenCV HSV2RGB_f sector table)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = h / 60.0
    sector = torch.floor(h)
    f = h - sector
    sector = torch.remainder(sector.to(torch.int32), 6)
    tab = (v, v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f)))
    # OpenCV's sector_data, RGB order: per sector the (r, g, b) tab picks.
    picks = ((0, 3, 1), (2, 0, 1), (1, 0, 3), (1, 2, 0), (3, 1, 0), (0, 1, 2))

    def channel(c):
        out = tab[picks[5][c]]
        for sec in range(4, -1, -1):
            out = torch.where(sector == sec, tab[picks[sec][c]], out)
        return out

    return torch.stack([channel(0), channel(1), channel(2)], dim=-1)


def hsv_jitter(rgb: torch.Tensor, dh, ds, dv) -> torch.Tensor:
    """The reference's HSV jitter (utils/dataloader.py:105-113) of float
    rgb [..., 3] in [0, 255], in cv2's float HSV space: hue + dh (degrees),
    saturation * ds, value * dv, clipped, back to rgb in [0, 255]. dh, ds
    and dv are numbers or tensors that broadcast against rgb[..., 0].

    The reference's H > 1 quirk is kept as is: it wraps the hue by 1 as if
    H ran over [0, 1], while cv2's H runs over [0, 360]."""
    hsv = rgb_to_hsv_cv2(rgb / 255.0)
    h = hsv[..., 0] + dh
    h = torch.where(h > 1.0, h - 1.0, h)
    h = torch.where(h < 0.0, h + 1.0, h)
    s = hsv[..., 1] * ds
    v = hsv[..., 2] * dv
    hsv = torch.stack([h.clamp(0.0, 360.0), s.clamp(0.0, 1.0), v.clamp(0.0, 1.0)], dim=-1)
    return hsv_to_rgb_cv2(hsv) * 255.0


def resize_np(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(image, size_wh) with INTER_LINEAR semantics, float32
    out. A uint8 image comes back rounded to whole grey levels."""
    w, h = size_wh
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    x = x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    y = y[0].permute(1, 2, 0)
    if image.dtype == np.uint8:
        y = torch.floor(y + 0.5).clamp_(0.0, 255.0)
    return y.contiguous().numpy()


def letterbox_params(
    image_hw: Tuple[int, int], target_hw: Tuple[int, int]
) -> Tuple[float, int, int, int, int]:
    """(scale, new_h, new_w, top, left) of the letterbox placement."""
    ih, iw = image_hw
    th, tw = target_hw
    scale = min(tw / iw, th / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    return scale, nh, nw, (th - nh) // 2, (tw - nw) // 2


def letterbox_np(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize pasted centred on a grey canvas.

    image: [H, W, 3] uint8 or float; size: (w, h). Returns float32 [h, w, 3].
    """
    w, h = size
    _, nh, nw, top, left = letterbox_params(image.shape[:2], (h, w))
    canvas = np.full((h, w, 3), LETTERBOX_FILL, dtype=np.float32)
    canvas[top : top + nh, left : left + nw] = resize_np(image, (nw, nh))
    return canvas


def serving_front_end(
    image: np.ndarray, size_wh: Tuple[int, int], letterbox: bool = True
) -> np.ndarray:
    """The serving preprocessing: letterbox (or plain resize) in the
    image's own dtype, then float and mean subtraction."""
    x = letterbox_np(image, size_wh) if letterbox else resize_np(image, size_wh)
    return preprocess_input_np(x.astype(np.float32))


def undo_letterbox_pixels(
    dets: np.ndarray,
    input_hw: Tuple[int, int],
    image_hw: Tuple[int, int],
    letterbox: bool = True,
) -> np.ndarray:
    """Normalized letterboxed dets [N, 15] -> original-image pixels.
    Mutates and returns `dets`."""
    if len(dets) == 0:
        return np.zeros((0, 15), np.float32)
    ih, iw = image_hw
    if letterbox:
        (ox, oy), (sx, sy) = correct_boxes_scale_offset(input_hw, image_hw)
        dets[:, [0, 2]] = (dets[:, [0, 2]] - ox) * sx
        dets[:, [1, 3]] = (dets[:, [1, 3]] - oy) * sy
        dets[:, 5::2] = (dets[:, 5::2] - ox) * sx
        dets[:, 6::2] = (dets[:, 6::2] - oy) * sy
    dets[:, [0, 2]] *= iw
    dets[:, [1, 3]] *= ih
    dets[:, 5::2] *= iw
    dets[:, 6::2] *= ih
    return dets


def cubic_resize_np(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(image.astype(float32), size_wh, interpolation=INTER_CUBIC)
    without cv2: half-pixel centres, A = -0.75, border-replicate taps, no
    antialias and no clip (cubic overshoot past [0, 255] stays). Two
    float32 matmuls with the dense matrices of `resize.cv2_cubic_taps`."""
    w, h = size_wh
    ih, iw = image.shape[:2]

    def dense(in_size, out_size):
        xmin, wts = R.cv2_cubic_taps(in_size, out_size)
        m = np.zeros((out_size, in_size), np.float32)
        rows = np.repeat(np.arange(out_size), 4)
        cols = np.minimum(xmin[:, None] + np.arange(4), in_size - 1).ravel()
        np.add.at(m, (rows, cols), wts.ravel())
        return torch.from_numpy(m)

    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
    c = x.shape[2]
    y = dense(ih, h) @ x.reshape(ih, iw * c)  # [h, iw * c]
    y = dense(iw, w) @ y.view(h, iw, c).transpose(0, 1).reshape(iw, h * c)
    return y.view(w, h, c).transpose(0, 1).contiguous().numpy()


def plan_letterbox(
    image_u8: np.ndarray,  # [ih, iw, 3] uint8
    target_hw: Tuple[int, int],
    bucket_hw: Tuple[int, int],
    letterbox: bool = True,
):
    """One image's letterbox as per-sample resample matrices (cv2
    INTER_LINEAR semantics, centred paste, fill 84) against a uint8
    source bucket, so one batched call letterboxes images of any sizes.
    A source larger than the bucket is first shrunk to fit (`resize_np`,
    within 1 grey level of the JAX package's cv2 INTER_LINEAR).

    Returns (padded_u8 [bh, bw, 3], (mv [th, bh], mh [tw, bw], inside_v
    [th], inside_h [tw]))."""
    ih, iw = image_u8.shape[:2]
    th, tw = target_hw
    bh, bw = bucket_hw
    if ih > bh or iw > bw:
        s = min(bh / ih, bw / iw)
        image_u8 = resize_np(image_u8, (max(int(iw * s), 1), max(int(ih * s), 1))).astype(np.uint8)
        ih, iw = image_u8.shape[:2]
    if letterbox:
        _, nh, nw, top, left = letterbox_params((ih, iw), (th, tw))
    else:  # a plain, aspect-breaking resize to the target
        nh, nw, top, left = th, tw, 0, 0
    padded = pad_to_bucket(image_u8, bucket_hw)
    mv, inside_v = R.paste_resize_matrix(ih, nh, top, th, bh, taps=R.cv2_bilinear_taps)
    mh, inside_h = R.paste_resize_matrix(iw, nw, left, tw, bw, taps=R.cv2_bilinear_taps)
    return padded, (mv, mh, inside_v, inside_h)


def letterbox_batch_device(
    images_u8: torch.Tensor,  # [B, bh, bw, 3] uint8 (bucketed sources)
    mv: torch.Tensor,  # [B, th, bh]
    mh: torch.Tensor,  # [B, tw, bw]
    inside_v: torch.Tensor,  # [B, th]
    inside_h: torch.Tensor,  # [B, tw]
    resample_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Bucketed uint8 sources + plans -> mean-subtracted float32 [B, th,
    tw, 3] frames: what letterbox_np + preprocess_input_np give, up to
    cv2's uint8 fixed-point rounding (and bfloat16's, by default)."""
    y = R.resample_canvas(
        images_u8, mv, mh, inside_v, inside_h, fill=LETTERBOX_FILL, resample_dtype=resample_dtype
    )
    return y - torch.tensor(MEANS, dtype=torch.float32, device=y.device)


# Composite cubic-prescale + bilinear-letterbox windows span at most
# 4 + ceil(1/scale) source taps; 16 covers pyramid scales down to ~0.09.
PYRAMID_TAPS_K = 16


def pad_to_bucket(image_u8: np.ndarray, bucket_hw: Tuple[int, int]) -> np.ndarray:
    """A [H, W, 3] uint8 image in the top-left corner of a [bh, bw, 3]
    source bucket; the rest is never read (plan weights are zero there)."""
    bh, bw = bucket_hw
    padded = np.empty((bh, bw, 3), np.uint8)
    ih, iw = image_u8.shape[:2]
    padded[:ih, :iw] = image_u8
    return padded


def plan_pyramid(
    image_hw: Tuple[int, int],
    scale: float,
    target_hw: Tuple[int, int],
    letterbox: bool = True,
    k_max: int = PYRAMID_TAPS_K,
):
    """One (image, pyramid scale) pair's recipe, float32 cv2 INTER_CUBIC
    pre-scale then the cv2 INTER_LINEAR letterbox onto the grey canvas, as
    ONE taps-form plan over the raw uint8 source: every scale reuses the
    same source upload.

    Returns ((xv, wv, inside_v, xh, wh, inside_h), (sh, sw)); (sh, sw) is
    the pre-scaled size the host recipe would have made (for the box
    undo)."""
    ih, iw = image_hw
    th, tw = target_hw
    sw = max(int(iw * scale), 32)
    sh = max(int(ih * scale), 32)
    if letterbox:
        _, nh, nw, top, left = letterbox_params((sh, sw), (th, tw))
    else:
        nh, nw, top, left = th, tw, 0, 0
    xv, wv, iv = R.compose_scale_letterbox_taps(ih, sh, nh, top, th, k_max)
    xh, wh, ihm = R.compose_scale_letterbox_taps(iw, sw, nw, left, tw, k_max)
    return (xv, wv, iv, xh, wh, ihm), (sh, sw)


def pyramid_batch_device(
    images_u8: torch.Tensor,  # [B, bh, bw, 3] uint8 (bucketed sources)
    xv: torch.Tensor,  # [B, th] integer
    wv: torch.Tensor,  # [B, th, K]
    inside_v: torch.Tensor,  # [B, th]
    xh: torch.Tensor,  # [B, tw] integer
    wh: torch.Tensor,  # [B, tw, K]
    inside_h: torch.Tensor,  # [B, tw]
) -> torch.Tensor:
    """Bucketed uint8 sources + composite pyramid plans -> mean-subtracted
    float32 [B, th, tw, 3] frames. All float32 with no clamp or rounding
    between the passes, as the host recipe it replaces (cv2 on float32,
    where cubic overshoot past [0, 255] is legitimate); full float32 only
    with TF32 off."""
    bh, bw = images_u8.shape[1], images_u8.shape[2]
    mv = R.expand_taps(xv, wv, bh, torch.float32)
    mh = R.expand_taps(xh, wh, bw, torch.float32)
    y = R.separable_resample(images_u8, mv, mh, torch.float32, clip_between=False)
    y = R.paste_fill(y, inside_v, inside_h, LETTERBOX_FILL)
    return y - torch.tensor(MEANS, dtype=torch.float32, device=y.device)


def correct_boxes_scale_offset(
    input_hw: Tuple[int, int], image_hw: Tuple[int, int]
):
    """Letterbox-undo terms: (offset_xy, scale_xy) to apply to normalized
    coords as (v - offset) * scale."""
    input_shape = np.asarray(input_hw, dtype=np.float64)
    image_shape = np.asarray(image_hw, dtype=np.float64)
    new_shape = image_shape * float(np.min(input_shape / image_shape))
    offset = (input_shape - new_shape) / 2.0 / input_shape  # (y, x)
    scale = input_shape / new_shape  # (y, x)
    return (offset[1], offset[0]), (scale[1], scale[0])


# Pillow's 8-bit resample (libImaging/Resample.c): coefficients in fixed
# point with PRECISION_BITS fractional bits, int32 sums started at half a
# unit, each pass clipped to uint8.
PIL_PRECISION_BITS = 32 - 8 - 2


def pil_fixed_taps(in_size: int, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for the bicubic
    filter, in its own float64 operation order: per output index the first
    source tap, the tap count and the fixed-point weights [out, ksize]
    (zero past the count). `resize.pil_bicubic_taps` is the same filter in
    float32, for the device's matmuls."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # (int) casts truncate toward zero, as astype does.
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # the C loop's order: sum tap by tap
        w = np.where(x < count, _pil_bicubic_filter(((x + xmin) - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww += w
    k = np.divide(k, ww[:, None], out=k, where=ww[:, None] != 0.0)
    scaled = k * (1 << PIL_PRECISION_BITS)
    fixed = np.trunc(np.where(k < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    return xmin, count, fixed


def _pil_pass(image: np.ndarray, axis: int, xmin, fixed) -> np.ndarray:
    """One Resample.c 8bpc pass along `axis` (0 rows, 1 columns) of a
    uint8 [H, W, C] image: int32 sums from 1 << (PRECISION_BITS - 1),
    clipped to [0, 255] after the shift. Integer sums do not depend on
    their order, so the pass runs tap by tap over whole rows."""
    x = np.moveaxis(image, axis, 0)
    n_in = x.shape[0]
    rows = np.ascontiguousarray(x).reshape(n_in, -1)
    acc = np.full((len(xmin), rows.shape[1]), 1 << (PIL_PRECISION_BITS - 1), np.int32)
    for k in range(fixed.shape[1]):
        # Taps past a row's count have weight 0; clamp their index.
        acc += rows[np.minimum(xmin + k, n_in - 1)] * fixed[:, k : k + 1]
    out = np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape((len(xmin),) + x.shape[1:]), 0, axis)


def pil_bicubic_resize(
    image: np.ndarray, size_wh: Tuple[int, int], window=None
) -> np.ndarray:
    """`PIL.Image.fromarray(image).resize(size_wh, Image.BICUBIC)` of a
    uint8 [H, W, C] image, byte for byte: the horizontal pass first, then
    the vertical one, each skipped when its size is unchanged.

    window (x0, y0, x1, y1) computes only that part of the output (as the
    full resize cropped to it, byte for byte): each output pixel depends
    on its own taps only."""
    h, w = image.shape[:2]
    ow, oh = size_wh
    x0, y0, x1, y1 = window if window is not None else (0, 0, ow, oh)
    out = image
    if (oh, ow) == (h, w):
        return np.ascontiguousarray(image[y0:y1, x0:x1])
    ymin, ycount, yfixed = pil_fixed_taps(h, oh) if oh != h else (None, None, None)
    if ow != w:
        xmin, _, xfixed = pil_fixed_taps(w, ow)
        if oh != h:  # only the source rows the vertical taps read
            first = int(ymin[y0:y1].min())
            last = int((ymin[y0:y1] + ycount[y0:y1]).max())
        else:
            first, last = y0, y1
        out = _pil_pass(image[first:last], 1, xmin[x0:x1], xfixed[x0:x1])
        if oh != h:
            ymin = ymin - first
    else:
        out = image[:, x0:x1]
    if oh != h:
        out = _pil_pass(out, 0, ymin[y0:y1], yfixed[y0:y1])
    return np.ascontiguousarray(out)
