"""WIDER FACE validation protocol (official re-implementation).

A copy of `jabd_tpu/eval/wider_eval.py` (numpy, and scipy's `loadmat`
imported where the ground truth is read): the port imports nothing of
the JAX package.

Faithful port of `utils/utils_map.py:100-223`: greedy IoU matching with
ignore regions, global min-max score normalization, 1000-threshold PR
sweep, VOC AP integration, Easy/Medium/Hard settings from the official
.mat ground truth. Default iou_thresh 0.4 (utils_map.py:173); the repo's
second copy (utils/evaluation.py) uses 0.5 — pass explicitly to choose.

Works from in-memory predictions ({event: {stem: [N,5] x,y,w,h,score}})
or a directory of per-image txt dumps in the reference layout.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

Pred = Dict[str, Dict[str, np.ndarray]]


def _bbox_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU on corner boxes (utils_map.py:7-27)."""
    max_xy = np.minimum(a[:, None, 2:], b[None, :, 2:])
    min_xy = np.maximum(a[:, None, :2], b[None, :, :2])
    inter = np.clip(max_xy - min_xy, 0, None)
    inter = inter[..., 0] * inter[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / (area_a + area_b - inter)


def read_pred_file(filepath: str) -> Tuple[str, np.ndarray]:
    """utils_map.py:45-58: line 0 image name, line 1 count, then
    `x y w h score` rows."""
    with open(filepath, "r") as f:
        lines = f.readlines()
    img_file = lines[0].rstrip("\n\r")
    boxes = []
    for line in lines[2:]:
        parts = line.rstrip("\r\n").split(" ")
        if parts[0] == "":
            continue
        boxes.append([float(v) for v in parts[:5]])
    return img_file.split("/")[-1], np.asarray(boxes, dtype=np.float64)


def load_pred_dir(pred_dir: str) -> Pred:
    """utils_map.py:60-74."""
    out: Pred = {}
    for event in os.listdir(pred_dir):
        event_dir = os.path.join(pred_dir, event)
        if not os.path.isdir(event_dir):
            continue
        cur = {}
        for txt in os.listdir(event_dir):
            name, boxes = read_pred_file(os.path.join(event_dir, txt))
            cur[name[:-4] if name.endswith(".jpg") else name] = boxes
        out[event] = cur
    return out


def norm_score(pred: Pred) -> None:
    """Global min-max normalize scores in place (utils_map.py:76-97)."""
    max_score, min_score = 0.0, 1.0
    for event in pred.values():
        for v in event.values():
            if len(v) == 0:
                continue
            min_score = min(min_score, float(np.min(v[:, -1])))
            max_score = max(max_score, float(np.max(v[:, -1])))
    diff = max_score - min_score
    if diff <= 0:
        return
    for event in pred.values():
        for v in event.values():
            if len(v) == 0:
                continue
            v[:, -1] = (v[:, -1] - min_score) / diff


def image_eval(
    pred: np.ndarray, gt: np.ndarray, ignore: np.ndarray, iou_thresh: float
) -> Tuple[np.ndarray, np.ndarray]:
    """utils_map.py:100-132: greedy match in prediction order, honoring
    the ignore list (ignore[g]==0 -> matches don't count, the proposal is
    discarded). pred is [N, 5] xywh+score sorted by descending score;
    gt is [M, 4] xywh."""
    _pred = pred.copy()
    _gt = gt.astype(np.float64).copy()
    pred_recall = np.zeros(_pred.shape[0])
    recall_list = np.zeros(_gt.shape[0])
    proposal_list = np.ones(_pred.shape[0])

    _pred[:, 2] = _pred[:, 2] + _pred[:, 0]
    _pred[:, 3] = _pred[:, 3] + _pred[:, 1]
    _gt[:, 2] = _gt[:, 2] + _gt[:, 0]
    _gt[:, 3] = _gt[:, 3] + _gt[:, 1]

    overlaps = _bbox_overlaps(_pred[:, :4], _gt)

    n_recalled = 0
    for h in range(_pred.shape[0]):
        gt_overlap = overlaps[h]
        max_idx = int(gt_overlap.argmax())
        if gt_overlap[max_idx] >= iou_thresh:
            if ignore[max_idx] == 0:
                recall_list[max_idx] = -1
                proposal_list[h] = -1
            elif recall_list[max_idx] == 0:
                recall_list[max_idx] = 1
                n_recalled += 1
        pred_recall[h] = n_recalled
    return pred_recall, proposal_list


def img_pr_info(
    thresh_num: int,
    pred_info: np.ndarray,
    proposal_list: np.ndarray,
    pred_recall: np.ndarray,
) -> np.ndarray:
    """utils_map.py:135-149 (vectorized over thresholds)."""
    pr_info = np.zeros((thresh_num, 2))
    scores = pred_info[:, 4]
    is_prop = proposal_list == 1
    cum_props = np.cumsum(is_prop)
    for t in range(thresh_num):
        thresh = 1 - (t + 1) / thresh_num
        r_index = np.where(scores >= thresh)[0]
        if len(r_index) == 0:
            continue
        r = r_index[-1]
        pr_info[t, 0] = cum_props[r]
        pr_info[t, 1] = pred_recall[r]
    return pr_info


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """utils_map.py:160-170."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def load_gt_mats(gt_dir: str):
    """utils_map.py:29-43."""
    from scipy.io import loadmat

    gt_mat = loadmat(os.path.join(gt_dir, "wider_face_val.mat"))
    settings = {}
    for name, fn in (
        ("easy", "wider_easy_val.mat"),
        ("medium", "wider_medium_val.mat"),
        ("hard", "wider_hard_val.mat"),
    ):
        settings[name] = loadmat(os.path.join(gt_dir, fn))["gt_list"]
    return (
        gt_mat["face_bbx_list"],
        gt_mat["event_list"],
        gt_mat["file_list"],
        settings,
    )


def evaluate_wider(
    pred: Pred | str,
    gt_path: str,
    iou_thresh: float = 0.4,
    thresh_num: int = 1000,
    normalize_scores: bool = True,
) -> Dict[str, float]:
    """Full protocol (utils_map.py:173-223). Returns
    {'easy': ap, 'medium': ap, 'hard': ap}."""
    if isinstance(pred, str):
        pred = load_pred_dir(pred)
    if normalize_scores:
        norm_score(pred)
    facebox_list, event_list, file_list, setting_gts = load_gt_mats(gt_path)
    event_num = len(event_list)
    aps: Dict[str, float] = {}
    for setting in ("easy", "medium", "hard"):
        gt_list = setting_gts[setting]
        count_face = 0
        pr_curve = np.zeros((thresh_num, 2))
        for i in range(event_num):
            event_name = str(event_list[i][0][0])
            img_list = file_list[i][0]
            pred_list = pred[event_name]
            sub_gt_list = gt_list[i][0]
            gt_bbx_list = facebox_list[i][0]
            for j in range(len(img_list)):
                pred_info = pred_list[str(img_list[j][0][0])]
                gt_boxes = gt_bbx_list[j][0].astype("float")
                keep_index = sub_gt_list[j][0]
                count_face += len(keep_index)
                if len(gt_boxes) == 0 or len(pred_info) == 0:
                    continue
                ignore = np.zeros(gt_boxes.shape[0])
                if len(keep_index) != 0:
                    ignore[keep_index - 1] = 1
                pred_recall, proposal_list = image_eval(
                    pred_info, gt_boxes, ignore, iou_thresh
                )
                pr_curve += img_pr_info(
                    thresh_num, pred_info, proposal_list, pred_recall
                )
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(
                pr_curve[:, 0] > 0, pr_curve[:, 1] / pr_curve[:, 0], 0.0
            )
        recall = pr_curve[:, 1] / max(count_face, 1)
        aps[setting] = voc_ap(recall, precision)
    return aps
