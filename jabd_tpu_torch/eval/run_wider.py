"""Batched WIDER FACE validation sweep.

Port of `jabd_tpu/eval/run_wider.py`. The val set streams through the
Predictor a batch at a time: host threads load and preprocess each chunk,
the device runs forward + top-k + decode + NMS (the CUDA kernel K1 on the
card) on the batch, and the host undoes the letterbox and writes the
reference's txt dumps. Three modes: single scale (host letterbox), and an
image pyramid whose pre-scale + letterbox runs on the host (`multiscale`)
or as one composed resample plan per scale on the device
(`pyramid="device"`).

Images come from a source the caller chooses: a WIDER `val/images`-style
directory, decoded as `cv2.imread` decodes (`decode_bgr`: PIL, the EXIF
orientation applied, BGR), or an in-memory mapping {(event, name): uint8
BGR [H, W, 3]}, for a machine where the files are absent or do not decode.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from jabd_tpu_torch.ops import image as I
from jabd_tpu_torch.ops.nms import nms_numpy
from jabd_tpu_torch.predict import map_txt_rows, rescale_pixels, undo_letterbox_pixels

# Sources past this are bilinearly pre-shrunk before a device-pyramid plan
# (as Predictor.detect_images caps its bucket): detail past the letterbox
# target is lost anyway.
_SRC_CAP = 2048

Source = Union[str, Mapping[Tuple[str, str], np.ndarray]]


def decode_bgr(source: Union[str, bytes]) -> np.ndarray:
    """What `cv2.imread(path)` gives, without cv2: uint8 [H, W, 3] in BGR
    order with the EXIF orientation applied, from a path or from the
    encoded bytes themselves (`cv2.imdecode`'s case). Uses PIL, imported
    here; raises ImportError where PIL is missing and PIL's
    UnidentifiedImageError for bytes it cannot decode."""
    import io

    from PIL import Image, ImageOps

    if isinstance(source, (bytes, bytearray, memoryview)):
        source = io.BytesIO(source)
    with Image.open(source) as im:
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


def _list_val_images(val_dir: str) -> List[Tuple[str, str]]:
    out = []
    for event in sorted(os.listdir(val_dir)):
        event_dir = os.path.join(val_dir, event)
        if not os.path.isdir(event_dir):
            continue
        for name in sorted(os.listdir(event_dir)):
            if name.lower().endswith((".jpg", ".png", ".jpeg")):
                out.append((event, name))
    return out


def _items(source: Source) -> List[Tuple[str, str]]:
    if isinstance(source, str):
        return _list_val_images(source)
    return sorted(source)


def _load(source: Source, item: Tuple[str, str]) -> np.ndarray:
    if isinstance(source, str):
        return decode_bgr(os.path.join(source, *item))
    return source[item]


def _scan_bucket(source: Source, items) -> Tuple[int, int]:
    """One source bucket for the whole sweep, ceil-128 of the largest
    (capped) side: from the image headers for a directory (PIL, no
    decode), from the arrays for a mapping."""
    bh = bw = 1
    for item in items:
        if isinstance(source, str):
            from PIL import Image

            with Image.open(os.path.join(source, *item)) as im:
                w, h = im.size
                # cv2.imread (and decode_bgr) apply the EXIF orientation;
                # the header's size does not. Orientations 5-8 transpose.
                if im.getexif().get(274, 1) in (5, 6, 7, 8):
                    w, h = h, w
        else:
            h, w = source[item].shape[:2]
        bh = max(bh, min(h, _SRC_CAP))
        bw = max(bw, min(w, _SRC_CAP))
    return -(-bh // 128) * 128, -(-bw // 128) * 128


def _merge_scales(predictor, per_scale: List[np.ndarray]) -> np.ndarray:
    """An image's dets over the pyramid's scales, through the host's
    greedy NMS and cut to max_detections."""
    if not per_scale:
        return np.zeros((0, 15), np.float32)
    m = np.concatenate(per_scale, 0)
    keep = nms_numpy(m[:, :4], m[:, 4], iou_threshold=predictor.pcfg.nms_iou)
    return m[keep[: predictor.pcfg.max_detections]]


def run_wider_val(
    predictor,
    val_dir: Source,
    batch_size: int = 32,
    out_dir: Optional[str] = None,
    num_workers: int = 8,
    multiscale: bool = False,
    scales=(0.75, 1.0, 1.25),
    pyramid: str = "host",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Sweep a WIDER val source (a directory, or a mapping {(event, name):
    uint8 BGR array}). Returns {event: {stem: [N, 5] x y w h score}} (the
    evaluator's in-memory format); with `out_dir` also writes the
    reference's txt dumps, byte for byte as the JAX package writes them.

    Single scale: host letterbox (`ops/image.py::letterbox_np`, within 1
    grey level of cv2's), one device batch per chunk. `multiscale`: per
    chunk one device batch per scale, then per image the merge through
    `nms_numpy`; `pyramid` chooses where each scale's pixels are made:

    * "host": the two-stage recipe of `Predictor.detect_multiscale`
      (float32 cv2-cubic pre-scale, then the letterbox);
    * "device": one uint8 upload per image and one composed taps-form
      plan per scale (`ops/image.py::plan_pyramid`), expanded and applied
      on the device in float32, within 0.05 grey levels of the host
      recipe; sources over 2048 px are first shrunk, which the host mode
      does not do.

    Unlike the JAX package, the last chunk is not padded to `batch_size`
    (a batch of any size runs the same graph here), so the partial batch
    costs only its own images."""
    if pyramid not in ("host", "device"):
        raise ValueError(f"pyramid must be 'host' or 'device', got {pyramid!r}")
    items = _items(val_dir)
    th, tw = predictor.pcfg.input_shape
    letterbox = predictor.pcfg.letterbox
    preds: Dict[str, Dict[str, np.ndarray]] = {}
    # stem -> the real file name: the txt header keeps its extension.
    fnames = {(event, os.path.splitext(name)[0]): name for event, name in items}

    def store(event, name, dets):
        preds.setdefault(event, {})[os.path.splitext(name)[0]] = map_txt_rows(dets)

    if multiscale and pyramid == "device":
        bh, bw = _scan_bucket(val_dir, items)

        def load(item):
            img = _load(val_dir, item)
            oh, ow = img.shape[:2]
            if oh > _SRC_CAP or ow > _SRC_CAP:
                r = min(_SRC_CAP / oh, _SRC_CAP / ow)
                img = I.resize_np(img, (max(int(ow * r), 1), max(int(oh * r), 1))).astype(np.uint8)
            plans = [I.plan_pyramid(img.shape[:2], s, (th, tw), letterbox) for s in scales]
            return item, (oh, ow), I.pad_to_bucket(img, (bh, bw)), plans

    elif multiscale:

        def load(item):
            img = _load(val_dir, item)
            ih, iw = img.shape[:2]
            per_scale = []
            for s in scales:
                sw, sh = max(int(iw * s), 32), max(int(ih * s), 32)
                scaled = I.cubic_resize_np(img, (sw, sh))
                x = I.letterbox_np(scaled, (tw, th)) if letterbox else I.resize_np(scaled, (tw, th))
                per_scale.append((I.preprocess_input_np(x), (sh, sw)))
            return item, (ih, iw), per_scale

    else:

        def load(item):
            img = _load(val_dir, item)
            x = I.preprocess_input_np(I.letterbox_np(img, (tw, th)).astype(np.float32))
            return item, img.shape[:2], x

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for lo in range(0, len(items), batch_size):
            loaded = list(pool.map(load, items[lo : lo + batch_size]))
            if multiscale:
                merged: List[List[np.ndarray]] = [[] for _ in loaded]
                if pyramid == "device":
                    src = torch.from_numpy(np.stack([p for _, _, p, _ in loaded])).to(predictor.device)
                for si in range(len(scales)):
                    if pyramid == "device":
                        parts = [
                            torch.from_numpy(np.stack([ld[3][si][0][pi] for ld in loaded])).to(predictor.device)
                            for pi in range(6)
                        ]
                        with torch.inference_mode():
                            frames = I.pyramid_batch_device(src, *parts)
                        sizes = [ld[3][si][1] for ld in loaded]
                    else:
                        frames = np.stack([ps[si][0] for _, _, ps in loaded])
                        sizes = [ps[si][1] for _, _, ps in loaded]
                    dets_b, valid_b = (t.cpu().numpy() for t in predictor.detect_preprocessed(frames))
                    for i, ((oh, ow), (sh, sw)) in enumerate(zip((ld[1] for ld in loaded), sizes)):
                        d = dets_b[i][valid_b[i]]
                        if len(d):
                            d = undo_letterbox_pixels(d, (th, tw), (sh, sw), letterbox)
                            # (sh, sw) is the pre-scale of the loaded (perhaps
                            # capped) image: ow / sw undoes the cap and the scale.
                            merged[i].append(rescale_pixels(d, ow / sw, oh / sh))
                for i, ld in enumerate(loaded):
                    store(*ld[0], _merge_scales(predictor, merged[i]))
            else:
                batch = np.stack([x for _, _, x in loaded])
                dets_b, valid_b = (t.cpu().numpy() for t in predictor.detect_preprocessed(batch))
                for i, ((event, name), (ih, iw), _) in enumerate(loaded):
                    d = dets_b[i][valid_b[i]]
                    if len(d):
                        (ox, oy), (sx, sy) = I.correct_boxes_scale_offset((th, tw), (ih, iw))
                        d[:, [0, 2]] = (d[:, [0, 2]] - ox) * sx * iw
                        d[:, [1, 3]] = (d[:, [1, 3]] - oy) * sy * ih
                    store(event, name, d)

    if out_dir:
        for event, imgs in preds.items():
            d = os.path.join(out_dir, event)
            os.makedirs(d, exist_ok=True)
            for stem, rows in imgs.items():
                fname = fnames.get((event, stem), stem + ".jpg")
                with open(os.path.join(d, stem + ".txt"), "w") as f:
                    f.write(f"{event}/{fname}\n{len(rows)}\n")
                    for r in rows:
                        f.write(f"{r[0]:.3f} {r[1]:.3f} {r[2]:.3f} {r[3]:.3f} {r[4]:.5f}\n")
    return preds
