"""5-point landmark face alignment onto the ArcFace template.

Port of `jabd_tpu/recognition/align.py`: `similarity_transform` (Umeyama,
float64), `align_face`, `landmarks_from_detection` and
`align_from_detections`. The JAX package warps with
`cv2.warpAffine(INTER_LINEAR, borderValue=0)` on the host; the port has
its own warp in torch (`warp_affine`), which runs where the image lies
(the card for `FacePipeline`, the CPU for numpy callers) and follows
OpenCV's floating-point warp (4.11 and later) operation by operation:

  * the 2x3 matrix is inverted in float64 (OpenCV's formula: 1/det, then
    the two translations), then rounded to float32;
  * per output row y, the row term float32(y * M1 + M2) is computed in
    float32, and the source x is fma(M0, x, row term) rounded once to
    float32 (likewise y); the tap is floor(x), the weight x - floor(x);
  * out-of-image taps read 0; each channel is interpolated as
    fma(a, p01 - p00, p00) along x, then fma(b, v1 - v0, v0) along y, in
    float32, and rounded half to even into uint8.

An fma of float32 values is emulated as a float64 multiply and a float64
add (separate operations, so no device fuses them), rounded to float32:
the product of two float32 values is exact in float64. Every operation
is a correctly rounded IEEE one on both devices, so the card's crops are
the CPU's byte for byte. OpenCV runs the last pixels of a row that do
not fill a SIMD vector through a scalar loop whose coordinates round
differently; at widths that are a multiple of the vector width (112 is
one) the warp is byte-equal to OpenCV's, otherwise those pixels may
differ by 1 grey level.
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical ArcFace / insightface 5-point template of a 112x112 crop: left
# eye, right eye, nose tip, left and right mouth corners.
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    np.float32,
)

# Crops warped per vectorised gather (bounds the float64 temporaries to
# about 100 MB a tensor at 112x112 on the CPU, 400 MB on the card).
_CHUNK = {"cpu": 64, "cuda": 256}


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (scale, rotation, translation) mapping
    `src` [N, 2] onto `dst` [N, 2] (Umeyama 1991); the 2x3 affine matrix
    as float32. A stack of point sets [B, N, 2] gives [B, 2, 3], each
    matrix computed as it would be alone."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[-2]
    mu_s = src.mean(axis=-2, keepdims=True)
    mu_d = dst.mean(axis=-2, keepdims=True)
    sd = src - mu_s
    dd = dst - mu_d
    cov = np.swapaxes(dd, -1, -2) @ sd / n
    u, s, vt = np.linalg.svd(cov)
    d = np.ones(s.shape)
    d[..., -1] = np.where(np.linalg.det(u) * np.linalg.det(vt) < 0, -1.0, 1.0)
    rot = (u * d[..., None, :]) @ vt  # u @ diag(d) @ vt
    var_s = (sd**2).sum(axis=(-2, -1)) / n
    scale = np.where(var_s > 0, (s * d).sum(axis=-1) / np.where(var_s > 0, var_s, 1.0), 1.0)
    a = scale[..., None, None] * rot
    t = mu_d[..., 0, :] - (a @ mu_s[..., 0, :, None])[..., 0]
    m = np.empty(src.shape[:-2] + (2, 3), np.float64)
    m[..., :2] = a
    m[..., 2] = t
    return m.astype(np.float32)


def _invert(m: np.ndarray) -> np.ndarray:
    """[N, 2, 3] forward matrices -> [N, 6] inverse maps in float64, by
    OpenCV's formula (a singular matrix maps everything to 0)."""
    m = m.reshape(-1, 6).astype(np.float64)
    det = m[:, 0] * m[:, 4] - m[:, 1] * m[:, 3]
    d = np.divide(1.0, det, out=np.zeros_like(det), where=det != 0)
    a11, a22 = m[:, 4] * d, m[:, 0] * d
    a12, a21 = -m[:, 1] * d, -m[:, 3] * d
    b1 = -a11 * m[:, 2] - a12 * m[:, 5]
    b2 = -a21 * m[:, 2] - a22 * m[:, 5]
    return np.stack([a11, a12, b1, a21, a22, b2], axis=1)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def warp_affine(image, mats: np.ndarray, size: int):
    """`cv2.warpAffine(image, m, (size, size), INTER_LINEAR, borderValue=0)`
    for each m of `mats` [N, 2, 3] (forward maps, image -> crop), in
    vectorised gathers of up to _CHUNK crops: [N, size, size, 3] uint8 from
    a [H, W, 3] uint8 image. A numpy image gives a numpy array; a tensor
    gives a tensor on its device, computed there."""
    if isinstance(image, np.ndarray):
        return warp_affine(torch.from_numpy(np.ascontiguousarray(image)), mats, size).numpy()
    h, w = image.shape[:2]
    # The image in float64 with a zero border of one pixel (and a fourth
    # channel, so each pixel is 32 contiguous bytes): a tap outside the
    # image is clamped onto the border and reads 0.
    padded = torch.zeros((h + 2, w + 2, 4), dtype=torch.float64, device=image.device)
    padded[1:-1, 1:-1, :3] = image
    flat = padded.view(-1, 4)
    inv = torch.from_numpy(_invert(np.asarray(mats, np.float32)).astype(np.float32)).to(image.device)
    chunk = _CHUNK.get(image.device.type, 64)
    return torch.cat([_warp_chunk(flat, h, w, inv[i : i + chunk], size)
                      for i in range(0, max(len(inv), 1), chunk)])


def _warp_chunk(flat: torch.Tensor, h: int, w: int, inv: torch.Tensor, size: int) -> torch.Tensor:
    dev = flat.device
    xs = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]

    def coord(m0, m1, m2):
        row = ys * m1[:, None, None] + m2[:, None, None]  # float32, [N, S, 1]
        return _fma32(m0[:, None, None].expand(len(m0), 1, size), xs, row)

    sx = coord(inv[:, 0], inv[:, 1], inv[:, 2])
    sy = coord(inv[:, 3], inv[:, 4], inv[:, 5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax = (sx - fx).double()[..., None]
    ay = (sy - fy).double()[..., None]
    # Clamp in float first: a coordinate far off the image may not fit an int.
    col0 = fx.clamp(-1, w).long() + 1
    col1 = (fx + 1).clamp(-1, w).long() + 1
    row0 = (fy.clamp(-1, h).long() + 1) * (w + 2)
    row1 = ((fy + 1).clamp(-1, h).long() + 1) * (w + 2)

    def lerp(a, rows, lo_cols, hi_cols):
        """float32(a * (hi - lo) + lo) of two taps: the product of a
        float32 weight and an integer difference, and its sum with an
        integer, are exact in float64, so the one rounding to float32 is
        an fma's."""
        out = flat[rows + hi_cols]
        lo = flat[rows + lo_cols]
        out -= lo
        out *= a
        out += lo
        return out.float()

    v0 = lerp(ax, row0, col0, col1)
    v1 = lerp(ax, row1, col0, col1)
    v = _fma32(ay, v1 - v0, v0)[..., :3]
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def align_face(image: np.ndarray, landmarks: np.ndarray, size: int = 112) -> np.ndarray:
    """Warp `image` so that `landmarks` [5, 2] (pixel coordinates) land on
    the ArcFace template scaled to `size`: the [size, size, 3] crop."""
    tmpl = ARCFACE_TEMPLATE * (size / 112.0)
    m = similarity_transform(np.asarray(landmarks, np.float32), tmpl)
    return warp_affine(image, m[None], size)[0]


def landmarks_from_detection(det: np.ndarray) -> np.ndarray:
    """[15] detection row (x1 y1 x2 y2 score lx1 ly1 ... lx5 ly5, the
    Predictor.detect_image pixel layout) -> [5, 2] landmarks."""
    return np.asarray(det[5:15], np.float32).reshape(5, 2)


def align_from_detections(image, dets: np.ndarray, size: int = 112, device=None):
    """Align every face of a [N, 15] detection array: [N, size, size, 3]
    crops in the image's channel order, as a numpy array; with `device`,
    warped there (the image copied over once) into a uint8 tensor that
    stays there."""
    if device is not None:
        image = torch.as_tensor(np.ascontiguousarray(image)).to(device)
    if len(dets) == 0:
        if device is not None:
            return torch.zeros((0, size, size, 3), dtype=image.dtype, device=device)
        return np.zeros((0, size, size, 3), image.dtype)
    tmpl = ARCFACE_TEMPLATE * (size / 112.0)
    landmarks = np.asarray(dets, np.float32)[:, 5:15].reshape(-1, 5, 2)
    return warp_affine(image, similarity_transform(landmarks, tmpl), size)
