"""Image front end: letterbox + mean subtraction, without cv2.

Port of `jabd_tpu/ops/image.py` (`preprocess_input_np`,
`serving_front_end`, `letterbox_np`, `letterbox_params`,
`correct_boxes_scale_offset`). The JAX package letterboxes with
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

import numpy as np
import torch
import torch.nn.functional as F

MEANS = (104.0, 117.0, 123.0)
LETTERBOX_FILL = 84.0  # the reference letterbox's grey (not 128)


def preprocess_input_np(image: np.ndarray) -> np.ndarray:
    """Subtract the channel means."""
    return image - np.asarray(MEANS, dtype=np.float32)


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
