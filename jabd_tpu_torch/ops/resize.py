"""Resize and adaptive average pooling on NCHW tensors, and the
per-sample resample plans of device augmentation, the batched device
letterbox and the image pyramid (PIL-bicubic, cv2-bilinear and cv2-cubic
taps; the batched resample as two matmuls).

Port of `jabd_tpu/ops/resize.py`. For `resize` / `adaptive_avg_pool` the
JAX package builds per-axis interpolation matrices with torch semantics
(bicubic A = -0.75, `align_corners=True` index mapping, nearest as
floor(i * in / out), adaptive bins [floor(i*in/out), ceil((i+1)*in/out)))
so that XLA can run them as matmuls; here the same maps are the torch
operators those matrices were written to match.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    mode: str = "nearest",
    align_corners: bool = True,
) -> torch.Tensor:
    """F.interpolate of NCHW x to (H', W'); a no-op at the same size."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(out_hw), mode="nearest")
    if mode in ("bilinear", "bicubic"):
        return F.interpolate(
            x, size=tuple(out_hw), mode=mode, align_corners=align_corners
        )
    raise ValueError(f"unknown resize mode {mode!r}")


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d on NCHW x."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


# ---------------------------------------------------------------------------
# Per-sample tap builders (host, numpy) and the batched resample (device).
#
# Copied from `jabd_tpu/ops/resize.py`. The geometry varies per sample
# (device augmentation): the host builds, per image and axis, the taps of
# a PIL-bicubic resize composed with a paste offset and a flip; the device
# turns them into dense [canvas, bucket] matrices and applies them as two
# batched matmuls. One shape covers any mix of source sizes.
# ---------------------------------------------------------------------------

_PIL_A = -0.5  # PIL's bicubic coefficient (vs torch/cv2's -0.75)


def _pil_bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (Resample.c bicubic_filter, a=-0.5)."""
    a = _PIL_A
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def pil_bicubic_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL precompute_coeffs: per output index, first source tap +
    normalized ANTIALIASED weights (support widens on downscale).

    Returns (xmin [out], weights [out, ksize]); taps are the contiguous
    range xmin..xmin+ksize-1 with trailing zero weights past the window
    (all real-tap indices stay inside [0, in_size))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.clip((center - support + 0.5).astype(np.int64), 0, None)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    count = xmax - xmin

    taps = xmin[:, None] + np.arange(ksize)[None, :]
    w = _pil_bicubic_filter((taps - center[:, None] + 0.5) / filterscale)
    w = np.where(np.arange(ksize)[None, :] < count[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.divide(w, ww, out=np.zeros_like(w), where=ww != 0.0)
    return xmin, w.astype(np.float32)


def paste_resize_matrix(
    in_size: int,
    out_len: int,
    offset: int,
    canvas: int,
    bucket: int,
    flip: bool = False,
    taps=pil_bicubic_taps,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense [canvas, bucket] matrix composing a resize (in_size ->
    out_len, semantics from `taps`) with a paste at `offset` (negative
    crops) and an optional output flip. Rows outside the pasted span are
    all-zero; `inside` marks pasted rows (callers add the gray fill).

    The augmentation ships the taps form (`paste_resize_taps`); this dense
    form is what `expand_taps` must rebuild from it, and the tests hold it
    there."""
    m = np.zeros((canvas, bucket), np.float32)
    inside = np.zeros((canvas,), np.float32)
    eff = max(out_len, 1)
    xmin, w = taps(in_size, eff)
    ksize = w.shape[1]

    lo = max(0, offset)
    hi = min(canvas, offset + eff)
    if hi > lo:
        o = np.arange(lo, hi)  # canvas indices covered by the paste
        u = o - offset  # resized-image indices
        cols = np.minimum(
            xmin[u][:, None] + np.arange(ksize)[None, :], in_size - 1
        )
        # Rows whose zero-weight tail taps clip onto in_size-1 need
        # accumulating writes (duplicate columns; numpy fancy assignment
        # does NOT guarantee write order). Those are only the few
        # right-edge rows — everything else takes the ~5x faster unique-
        # column fancy assignment.
        clipped = xmin[u] > in_size - ksize
        clean = ~clipped
        if clean.any():
            m[o[clean][:, None], cols[clean]] = w[u][clean]
        if clipped.any():
            np.add.at(
                m, (o[clipped][:, None], cols[clipped]), w[u][clipped]
            )
        inside[lo:hi] = 1.0
    if flip:
        # Negative-stride views are fine: batch assembly copies.
        m = m[::-1]
        inside = inside[::-1]
    return m, inside


# Static tap budget of the compact (taps-form) plan shipping. Rows never
# carry more than TAPS_K weights because plan builders pre-shrink any
# source axis whose downscale factor exceeds TAPS_FSCAP (antialiased
# support 2*fscale per side -> ksize = 2*ceil(2*fscale)+1 <= 31).
TAPS_FSCAP = 7.5
TAPS_K = 32


def paste_resize_taps(
    in_size: int,
    out_len: int,
    offset: int,
    canvas: int,
    flip: bool = False,
    taps=pil_bicubic_taps,
    k_max: int = TAPS_K,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact (taps-form) equivalent of `paste_resize_matrix`: per canvas
    row, the first source tap index and k_max weights, instead of a dense
    [canvas, bucket] matrix (bucket/k_max times fewer bytes to ship to the
    device, which rebuilds the dense matrix with `expand_taps`).

    Returns (xmin [canvas] int32, w [canvas, k_max] float32,
    inside [canvas] float32). Rows outside the pasted span have all-zero
    weights. Requires in_size <= TAPS_FSCAP * max(out_len, 1) * 2 + k_max
    headroom — callers guarantee it by pre-shrinking (see
    device_augment.plan_sample); asserts otherwise.
    """
    xmin_c = np.zeros((canvas,), np.int32)
    w_c = np.zeros((canvas, k_max), np.float32)
    inside = np.zeros((canvas,), np.float32)
    eff = max(out_len, 1)
    xmin, w = taps(in_size, eff)
    ksize = w.shape[1]

    lo = max(0, offset)
    hi = min(canvas, offset + eff)
    if hi > lo:
        o = np.arange(lo, hi)  # canvas indices covered by the paste
        u = o - offset  # resized-image indices
        if ksize > k_max:
            # Trailing taps past each row's count are zero-weight; they
            # only exceed k_max when the antialias window does, which the
            # pre-shrink contract forbids. Verify, then truncate.
            assert not np.any(w[u][:, k_max:] != 0.0), (
                "tap window exceeds TAPS_K — caller must pre-shrink "
                f"(in={in_size}, out={out_len})"
            )
        xm = xmin[u].astype(np.int64)
        wr = np.zeros((len(u), k_max), np.float32)
        wr[:, : min(ksize, k_max)] = w[u][:, :k_max]
        # Right-edge clip: dense form accumulates taps clipped onto
        # in_size-1; re-lay the weights against a shifted window start so
        # the device needs no per-sample clamp (all xm+k either fall
        # inside the source or carry zero weight).
        clipped = xm > in_size - min(ksize, k_max)
        for r in np.nonzero(clipped)[0]:
            cols = np.minimum(xm[r] + np.arange(k_max), in_size - 1)
            new_xm = max(0, min(int(xm[r]), in_size - k_max))
            neww = np.zeros((k_max,), np.float32)
            np.add.at(neww, cols - new_xm, wr[r])
            xm[r] = new_xm
            wr[r] = neww
        xmin_c[lo:hi] = xm
        w_c[lo:hi] = wr
        inside[lo:hi] = 1.0
    if flip:
        xmin_c = xmin_c[::-1]
        w_c = w_c[::-1]
        inside = inside[::-1]
    return xmin_c, w_c, inside


def expand_taps(
    xmin: torch.Tensor,  # [B, S] integer
    w: torch.Tensor,  # [B, S, K]
    bucket: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The dense [B, S, bucket] resample matrix of a taps-form plan: row
    (b, s) holds w[b, s, k] at column xmin[b, s] + k. The K columns of a
    row are distinct, so one scatter writes them; columns past the bucket
    carry zero weight and land in a margin that is cut off."""
    b, s, k_max = w.shape
    idx = xmin.to(torch.int64)[:, :, None] + torch.arange(k_max, device=w.device)
    dense = torch.zeros((b, s, bucket + k_max), dtype=dtype, device=w.device)
    dense.scatter_(2, idx, w.to(dtype))
    return dense[:, :, :bucket]


def separable_resample(
    images: torch.Tensor,  # [B, bucket_h, bucket_w, C]
    mv: torch.Tensor,  # [B, th, bucket_h]
    mh: torch.Tensor,  # [B, tw, bucket_w]
    dtype: torch.dtype,
    clip_between: bool,
) -> torch.Tensor:
    """[B, th, tw, C] = mv . images . mh^T per sample, as two batched
    matmuls in `dtype`: rows first, then columns (optionally clipped to
    [0, 255] between them). The result stays in `dtype`."""
    b, bh, bw, c = images.shape
    th, tw = mv.shape[1], mh.shape[1]
    x = images.to(dtype).reshape(b, bh, bw * c)
    # Vertical: [B, th, bh] x [B, bh, bw*C] -> [B, th, bw, C].
    y = torch.bmm(mv.to(dtype), x)
    if clip_between:
        y = y.clamp_(0.0, 255.0)
    # Horizontal: [B, tw, bw] x [B, bw, th*C] -> [B, tw, th, C].
    y = y.view(b, th, bw, c).transpose(1, 2).reshape(b, bw, th * c)
    return torch.bmm(mh.to(dtype), y).view(b, tw, th, c).transpose(1, 2)


def paste_fill(y: torch.Tensor, inside_v, inside_h, fill: float) -> torch.Tensor:
    """y [B, th, tw, C] where both the row and the column were pasted, the
    grey `fill` elsewhere."""
    inside = (inside_v.float()[:, :, None] * inside_h.float()[:, None, :])[..., None]
    return y * inside + fill * (1.0 - inside)


def resample_canvas(
    images_u8: torch.Tensor,  # [B, bucket_h, bucket_w, 3] uint8
    mv: torch.Tensor,  # [B, th, bucket_h]
    mh: torch.Tensor,  # [B, tw, bucket_w]
    inside_v: torch.Tensor,  # [B, th]
    inside_h: torch.Tensor,  # [B, tw]
    fill: float,
    resample_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Apply per-sample separable resample+paste matrices and the grey
    fill: float32 [B, th, tw, 3] in [0, 255] (th != tw allowed). Two
    batched matmuls in `resample_dtype` (float32 runs at full float32
    precision only with TF32 off): rows first, a clip to [0, 255] between
    them (PIL clamps each pass), then columns, rounded to whole grey
    levels. Shared by device augmentation (fill 128) and the batched
    device letterbox (fill 84)."""
    y = separable_resample(images_u8, mv, mh, resample_dtype, clip_between=True)
    y = torch.round(y.float()).clamp_(0.0, 255.0)
    return paste_fill(y, inside_v, inside_h, fill)


# ---------------------------------------------------------------------------
# cv2 resize semantics as taps, copied from `jabd_tpu/ops/resize.py`: the
# batched device letterbox (INTER_LINEAR), the image pyramid's pre-scale
# (INTER_CUBIC on float32) and the two composed into one plan.
# ---------------------------------------------------------------------------

_A = -0.75  # cv2's and torch's bicubic coefficient (cubic convolution)


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """4-tap cubic convolution weights at fractional offset t in [0,1),
    A = -0.75: [..., 4] for taps (floor-1, floor, floor+1, floor+2)."""
    a = _A

    def w1(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def w2(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return np.stack([w2(t + 1), w1(t), w1(1 - t), w2(2 - t)], axis=-1)


def cv2_bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.resize INTER_LINEAR float semantics: half-pixel centres, two
    taps, no antialiasing on downscale. Same (xmin, weights) contract as
    pil_bicubic_taps."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    t = (src - x0).astype(np.float32)
    # Edge clamp: out-of-range taps collapse onto the border pixel.
    lo = np.clip(x0, 0, in_size - 1)
    hi = np.clip(x0 + 1, 0, in_size - 1)
    xmin = np.minimum(lo, hi)
    w = np.zeros((out_size, 2), np.float32)
    np.add.at(w, (np.arange(out_size), lo - xmin), 1.0 - t)
    np.add.at(w, (np.arange(out_size), hi - xmin), t)
    return xmin, w


def cv2_cubic_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.resize INTER_CUBIC float semantics: half-pixel centres, 4-tap
    cubic with A = -0.75, border-replicate tap clamp, no antialiasing on
    downscale and no clip of the source coordinate (the centre may go
    negative at the top edge; the taps are clamped instead). Window start
    + 4 weights, out-of-range taps accumulated onto the border pixel
    inside the window."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    w = _cubic_weights((src - x0).astype(np.float64)).astype(np.float32)
    xmin = np.clip(x0 - 1, 0, max(in_size - 4, 0))
    out_w = np.zeros((out_size, 4), np.float32)
    rows = np.arange(out_size)
    for j in range(4):
        cols = np.clip(x0 - 1 + j, 0, in_size - 1) - xmin
        np.add.at(out_w, (rows, cols), w[:, j])
    return xmin, out_w


def compose_scale_letterbox_taps(
    in_size: int,
    mid_size: int,
    out_len: int,
    offset: int,
    canvas: int,
    k_max: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The image pyramid's two host resizes as ONE taps-form plan over the
    original source axis: cv2-cubic (in_size -> mid_size, the pre-scale)
    composed with cv2-bilinear (mid_size -> out_len, the letterbox fit)
    pasted at `offset` on a `canvas`-long axis. Both maps are linear, so
    the composition is exact up to float32 association.

    The composite window spans at most 4 + ceil(in/mid) source taps;
    asserts it fits k_max. Returns (xmin [canvas] int32, w [canvas, k_max]
    float32, inside [canvas] float32), all-zero weight rows outside the
    pasted span (callers add the grey fill)."""
    cx, cw = cv2_cubic_taps(in_size, mid_size)
    px, pw, inside = paste_resize_taps(
        mid_size, out_len, offset, canvas, taps=cv2_bilinear_taps, k_max=2
    )
    j0 = px.astype(np.int64)
    j1 = np.minimum(j0 + 1, mid_size - 1)
    start = np.minimum(cx[j0], cx[j1])
    k_req = int(np.max(np.maximum(cx[j0], cx[j1]) + 4 - start)) if canvas else 0
    assert k_req <= k_max, (
        f"composite tap window {k_req} exceeds k_max={k_max} "
        f"(in={in_size}, mid={mid_size}) - raise k_max or pre-shrink"
    )
    w = np.zeros((canvas, k_max), np.float32)
    rows = np.arange(canvas)
    for q, jq in enumerate((j0, j1)):
        off = cx[jq] - start
        for t in range(4):
            np.add.at(w, (rows, off + t), pw[:, q] * cw[jq, t])
    w *= inside[:, None]
    return start.astype(np.int32), w, inside
