"""Plain reference of batch detection, and the comparison that judges the
served detections by it.

The reference recipe for one uint8 image (the reference repository's
predict.py with `letterbox_image`, `PriorBox`, `decode`, `decode_landm`
and `retinaface_correct_boxes`): an aspect-kept bilinear resize (cv2
INTER_LINEAR: half-pixel centres, edge taps clamped, rounded back to
whole grey levels) pasted centred on a grey (84) canvas, the channel
means subtracted, the float32 forward, every anchor decoded, and the rows
mapped back to the image's pixels. `reference_rows` returns that row for
EVERY anchor; `Comparison` then holds the served detections of each
image against them. Each served row is matched to the anchor whose 14
coordinates (box and landmarks, pixels) lie nearest in max-abs distance;
its distance and its score's departure from that anchor's are recorded.
The NMS is held to greedy NMS's two defining rules, on the reference's
boxes and scores of the matched anchors: no two served rows overlap above
the threshold, and every reference candidate that was not served has an
excuse: suppressed by a served row (IoU above the threshold, score at
least its own), below the served set's lowest score when that set is
full, below the pre-NMS top-k, or below the confidence. A served set that
keeps both rules is the greedy NMS of the reference's candidates (the two
rules characterise it uniquely); served in a lower precision, the rules
break near their thresholds, at a rate that grows with the rounding.

`greedy_keep` is an exact greedy NMS in blocks of 256 candidates, used to
count the operations the NMS kernel's inputs need (counts.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import fp8_round

MEANS = (104.0, 117.0, 123.0)
FILL = 84.0
COORDS = [0, 1, 2, 3] + list(range(5, 15))  # box and landmarks of a [.., 15] row


def anchors(anchor_cfg: dict, size: Tuple[int, int]) -> torch.Tensor:
    """[P, 4] normalized (cx, cy, w, h): per level (ceil(H/s), ceil(W/s))
    cells row-major, the min sizes innermost."""
    h, w = size
    out = []
    for step, sizes in zip(anchor_cfg["steps"], anchor_cfg["min_sizes"]):
        fh, fw = -(-h // step), -(-w // step)
        cy = (torch.arange(fh, dtype=torch.float64) + 0.5) * step / h
        cx = (torch.arange(fw, dtype=torch.float64) + 0.5) * step / w
        m = torch.tensor(sizes, dtype=torch.float64)
        lvl = torch.empty(fh, fw, len(sizes), 4, dtype=torch.float64)
        lvl[..., 0] = cx[None, :, None]
        lvl[..., 1] = cy[:, None, None]
        lvl[..., 2] = m / w
        lvl[..., 3] = m / h
        out.append(lvl.reshape(-1, 4))
    return torch.cat(out).float()


def placement(image_hw, target_hw):
    """(scale, new_h, new_w, top, left) of the letterbox."""
    ih, iw = image_hw
    th, tw = target_hw
    s = min(tw / iw, th / ih)
    nw, nh = int(iw * s), int(ih * s)
    return s, nh, nw, (th - nh) // 2, (tw - nw) // 2


def letterbox(image_u8: np.ndarray, target_hw, device, precision: str = "float32") -> torch.Tensor:
    """One uint8 [H, W, 3] image -> mean-subtracted float32 [3, th, tw].
    `precision` 'bfloat16' or 'float8' rounds the resample's result to it
    (float8: its input too) before the rounding to grey levels."""
    th, tw = target_hw
    _, nh, nw, top, left = placement(image_u8.shape[:2], target_hw)
    x = torch.from_numpy(np.ascontiguousarray(image_u8)).to(device).permute(2, 0, 1)[None].float()
    if precision == "float8":
        x = fp8_round(x)
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    if precision == "float8":
        y = fp8_round(y)
    elif precision == "bfloat16":
        y = y.to(torch.bfloat16).float()
    y = torch.floor(y + 0.5).clamp_(0.0, 255.0)[0]
    canvas = torch.full((3, th, tw), FILL, dtype=torch.float32, device=device)
    canvas[:, top:top + nh, left:left + nw] = y
    return canvas - torch.tensor(MEANS, device=device)[:, None, None]


def decode_rows(loc, conf, landm, priors, variances) -> torch.Tensor:
    """Heads of one batch -> [B, P, 15] normalized rows [box, score, landmarks]."""
    v0, v1 = variances
    cxcy = priors[:, :2] + loc[..., :2] * v0 * priors[:, 2:]
    wh = priors[:, 2:] * torch.exp(loc[..., 2:] * v1)
    x1y1 = cxcy - wh / 2
    pts = priors[:, None, :2] + landm.reshape(*landm.shape[:-1], 5, 2) * v0 * priors[:, None, 2:]
    return torch.cat([x1y1, x1y1 + wh, conf[..., 1:2], pts.flatten(-2)], -1)


def to_pixels(rows: torch.Tensor, image_hw, target_hw) -> torch.Tensor:
    """Normalized letterboxed rows [P, 15] -> the image's pixels, by the
    reference's retinaface_correct_boxes: (v - offset) * scale * size with
    the unrounded letterbox scale."""
    ih, iw = image_hw
    th, tw = target_hw
    s = min(th / ih, tw / iw)
    ox, oy = (tw - iw * s) / 2.0 / tw, (th - ih * s) / 2.0 / th
    fx, fy = tw / (iw * s) * iw, th / (ih * s) * ih
    out = rows.clone()
    out[:, [0, 2, 5, 7, 9, 11, 13]] = (rows[:, [0, 2, 5, 7, 9, 11, 13]] - ox) * fx
    out[:, [1, 3, 6, 8, 10, 12, 14]] = (rows[:, [1, 3, 6, 8, 10, 12, 14]] - oy) * fy
    return out


@torch.no_grad()
def forward_rows(model, images: Sequence[np.ndarray], target_hw, priors, variances, device,
                 precision: str = "float32") -> torch.Tensor:
    """[B, P, 15] normalized rows of every anchor: letterbox, the eval
    forward, decode. `precision` 'bfloat16' letterboxes in it and runs the
    forward under autocast (plain bfloat16 inference); 'float8'
    letterboxes in float8 (the model's float8 convolutions are set on it,
    `set_fp8`)."""
    device = torch.device(device)
    x = torch.stack([letterbox(im, target_hw, device, precision) for im in images])
    with torch.autocast(device.type, dtype=torch.bfloat16, enabled=precision == "bfloat16"):
        heads = [h.float() for h in model(x)]
    return decode_rows(*heads, priors, variances)


def reference_rows(model, images: Sequence[np.ndarray], target_hw, priors, variances, device) -> List[torch.Tensor]:
    """[P, 15] pixel rows of every anchor, one tensor per image, from the
    float32 reference model."""
    rows = forward_rows(model, images, target_hw, priors, variances, device)
    return [to_pixels(rows[i], im.shape[:2], target_hw) for i, im in enumerate(images)]


def candidates(rows: torch.Tensor, settings: dict):
    """The best `pre_nms_topk` of [B, P, 15] rows by descending score
    (stable), those under the confidence invalid: (rows [B, k, 15],
    valid [B, k])."""
    scores = torch.where(rows[..., 4] >= settings["confidence"], rows[..., 4], -1.0)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :settings["pre_nms_topk"]], idx[:, :settings["pre_nms_topk"]]
    return torch.gather(rows, 1, idx[..., None].expand(-1, -1, rows.shape[-1])), top >= 0


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] corner boxes -> [N, M] IoU (0 where the union is 0)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0.0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def nearest_anchor(served: torch.Tensor, ref: torch.Tensor, chunk: int = 8192):
    """For each served row the reference anchor nearest in the max-abs
    distance over the 14 coordinates: (index [N], distance [N])."""
    best_d = torch.full((served.shape[0],), float("inf"), device=served.device)
    best_i = torch.zeros(served.shape[0], dtype=torch.int64, device=served.device)
    s = served[:, COORDS]
    for p0 in range(0, ref.shape[0], chunk):
        r = ref[p0:p0 + chunk][:, COORDS]
        d = (s[:, None, :] - r[None, :, :]).abs().amax(-1)
        v, i = d.min(1)
        better = v < best_d
        best_d = torch.where(better, v, best_d)
        best_i = torch.where(better, i + p0, best_i)
    return best_i, best_d


def image_stats(served: np.ndarray, ref: torch.Tensor, settings: dict) -> Dict[str, float]:
    """Sums, counts and maxima of one image (module docstring). `served`
    is the program's [N, 15] pixel rows in its order, `ref` the [P, 15]
    reference rows of every anchor."""
    thr, conf = settings["nms_iou"], settings["confidence"]
    dev = ref.device
    d = torch.from_numpy(np.asarray(served, dtype=np.float32).reshape(-1, 15)).to(dev)
    scores = ref[:, 4]
    valid = scores >= conf
    n_cand = int(valid.sum())
    out = dict.fromkeys(STATS, 0.0)
    out["rows"] = float(d.shape[0])
    out["candidates"] = float(n_cand)
    matched = torch.zeros_like(valid)
    kept = ref[:0]
    if d.shape[0]:
        a, dist = nearest_anchor(d, ref)
        dscore = (d[:, 4] - scores[a]).abs()
        out.update(box_sum=float(dist.sum()), box_max=float(dist.max()),
                   score_sum=float(dscore.sum()), score_max=float(dscore.max()))
        kept = ref[a]
        iou = torch.triu(pairwise_iou(kept[:, :4], kept[:, :4]), diagonal=1)
        out.update(overlap_pairs=float((iou > thr).sum()), overlap_max=max(float(iou.max()) - thr, 0.0))
        matched[a] = True
    cand = torch.nonzero(valid & ~matched).flatten()
    if not len(cand):
        return out
    s_c = scores[cand]
    excuse = s_c - conf
    k = settings["pre_nms_topk"]
    if k < n_cand:
        excuse = torch.minimum(excuse, s_c - torch.topk(scores[valid], k).values[-1])
    if d.shape[0] >= settings["max_detections"]:
        excuse = torch.minimum(excuse, s_c - kept[:, 4].min())
    if d.shape[0]:
        sup = torch.full_like(s_c, float("inf"))
        for c0 in range(0, len(cand), 16384):
            c = cand[c0:c0 + 16384]
            iou = pairwise_iou(kept[:, :4], ref[c, :4])  # [N, C]
            miss = torch.maximum(thr - iou, scores[c][None, :] - kept[:, 4:5]).clamp(min=0.0)
            sup[c0:c0 + len(c)] = miss.min(0).values
        excuse = torch.minimum(excuse, sup)
    out.update(missed=float((excuse > 0).sum()), missed_max=float(excuse.max().clamp(min=0.0)))
    return out


STATS = ("rows", "candidates", "box_sum", "box_max", "score_sum", "score_max", "overlap_pairs", "overlap_max", "missed",
         "missed_max")


class Comparison:
    """The served detections of many images against the reference, as
    means over every served row (`raw()`):

      box_gap_px   distance (px) of a served row to its nearest anchor;
      score_gap    |served score - that anchor's reference score|;
      nms_overlap  served pairs whose reference IoU exceeds the threshold,
                   per served row;
      nms_missed   reference candidates that escape every excuse, per
                   served row.

    `diagnostics()` adds the maxima over rows and images and per image."""

    def __init__(self, settings: dict):
        self.settings = settings
        self.sums = dict.fromkeys(STATS, 0.0)
        self.maxima = {"box_max": 0.0, "score_max": 0.0, "overlap_max": 0.0, "missed_max": 0.0}
        self.images = []

    def add(self, served: Sequence[np.ndarray], ref_rows: Sequence[torch.Tensor]) -> None:
        """One batch: `served` must hold one [N_i, 15] array per image."""
        if len(served) != len(ref_rows):
            raise ValueError(f"{len(served)} results for {len(ref_rows)} images")
        for got, ref in zip(served, ref_rows):
            st = image_stats(got, ref, self.settings)
            for key in self.sums:
                self.sums[key] += st[key]
            for key in self.maxima:
                self.maxima[key] = max(self.maxima[key], st[key])
            n = max(st["rows"], 1.0)
            self.images.append([int(st["rows"]), round(st["box_sum"] / n, 4), round(st["score_sum"] / n, 5),
                                int(st["overlap_pairs"]), int(st["missed"])])

    def raw(self) -> Dict[str, float]:
        n = max(self.sums["rows"], 1.0)
        return {"box_gap_px": self.sums["box_sum"] / n, "score_gap": self.sums["score_sum"] / n,
                "nms_overlap": self.sums["overlap_pairs"] / n, "nms_missed": self.sums["missed"] / n}

    def diagnostics(self) -> dict:
        """The maxima, the reference's candidates (scores at or above the
        confidence) per image, and per image [rows, mean box gap, mean
        score gap, overlapping pairs, missed candidates]."""
        return {**self.maxima, "rows": self.sums["rows"],
                "candidates_per_image": self.sums["candidates"] / max(len(self.images), 1), "images": self.images}


# The compared numbers: each raw mean of the served detections over the
# same mean of plain bfloat16 inference of the reference (autocast, the
# letterbox rounded to bfloat16): the configuration's precision done the
# straightforward way. How far bfloat16 moves a seeded detector differs
# from seed to seed by an order of magnitude; in units of that the served
# program reads alike on every seed. Counts take a floor of one count
# over all the rows.
RATIOS = {"box_gap": "box_gap_px", "score_gap": "score_gap", "nms_overlap": "nms_overlap", "nms_missed": "nms_missed"}


def ratios(served: "Comparison", yardstick: "Comparison") -> Dict[str, float]:
    got, unit = served.raw(), yardstick.raw()
    floor = 1.0 / max(yardstick.sums["rows"], 1.0)
    return {name: got[key] / max(unit[key], floor if key.startswith("nms") else 1e-12)
            for name, key in RATIOS.items()}


def readings(ratio: Dict[str, float]) -> Dict[str, float]:
    """The four ratios and `nms_rules`, the sum of the two NMS rules'
    (overlapping pairs, missed candidates): one number that either broken
    rule moves. A cell's limits file names the ones it compares."""
    return {**ratio, "nms_rules": ratio["nms_overlap"] + ratio["nms_missed"]}


def reference_detect(model, images: Sequence[np.ndarray], target_hw, priors, variances, settings, device,
                     precision: str = "float32"):
    """The reference in the program's place: `forward_rows` at
    `precision`, `candidates`, exact greedy NMS, the first
    `max_detections` kept rows in pixels."""
    cand, valid = candidates(forward_rows(model, images, target_hw, priors, variances, device, precision), settings)
    keep = greedy_keep(cand[..., :4].contiguous(), valid, settings["nms_iou"])
    out = []
    for i, im in enumerate(images):
        kept = cand[i][keep[i]][: settings["max_detections"]]
        out.append(to_pixels(kept, im.shape[:2], target_hw).cpu().numpy())
    return out


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, thr: float, block: int = 256) -> torch.Tensor:
    """Exact greedy IoU NMS of score-sorted [B, K, 4] boxes (valid rows a
    prefix): keep masks [B, K]. Within a block of rows the rule runs on the
    host, one row at a time; each block's kept rows then remove every
    later row they overlap above `thr` in one pass on the device."""
    bsz, k = valid.shape
    removed = ~valid
    n_max = int(valid.sum(1).max()) if bsz else 0
    for r0 in range(0, n_max, block):
        r1 = min(r0 + block, k)
        blk = boxes[:, r0:r1]
        over = torch.stack([pairwise_iou(blk[b], blk[b]) > thr for b in range(bsz)]).cpu().numpy()
        rem = removed[:, r0:r1].cpu().numpy().copy()
        for i in range(r1 - r0):
            rem[:, i + 1:] |= (~rem[:, i])[:, None] & over[:, i, i + 1:]
        rem_t = torch.from_numpy(rem).to(boxes.device)
        removed[:, r0:r1] = rem_t
        if r1 < k:
            for b in range(bsz):
                rows = blk[b][~rem_t[b]]
                if len(rows):
                    hit = (pairwise_iou(rows, boxes[b, r1:]) > thr).any(0)
                    removed[b, r1:] |= hit
    return ~removed
