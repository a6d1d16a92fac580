"""Open/closed-set identification protocols for low-quality faces.

A copy of `jabd_tpu/recognition/identification.py` (numpy only).

Port of the probe/gallery ranking machinery behind the reference's
TinyFace and IJB-S evaluations: `DIR_FAR` (validation_lq/
tinyface_helper.py:86-170 / PFE/utils.py), threshold search by FAR, and
the TinyFace-style rank-k retrieval harness
(validation_lq/validate_tinyface.py with flip-TTA fusion methods :29-65).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def inner_product(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Cosine scores for l2-normalized features
    (tinyface_helper.py:70-83)."""
    return np.dot(x1, x2.T)


def find_thresholds_by_FAR(
    score_vec: np.ndarray,
    label_vec: np.ndarray,
    FARs: Sequence[float],
    epsilon: float = 1e-5,
) -> np.ndarray:
    """Threshold per requested false-accept rate over non-mate scores."""
    assert score_vec.ndim == 1 and score_vec.shape == label_vec.shape
    score_neg = np.sort(score_vec[~label_vec.astype(bool)])[::-1]
    num_neg = len(score_neg)
    thresholds = []
    for far in FARs:
        if far <= 0.0:
            thresholds.append(score_neg[0] + epsilon)
        else:
            num_false_alarms = int(np.ceil(num_neg * far))
            if num_false_alarms >= num_neg:
                thresholds.append(score_neg[-1] - epsilon)
            else:
                thresholds.append(score_neg[num_false_alarms - 1] + epsilon)
    return np.asarray(thresholds)


def DIR_FAR(
    score_mat: np.ndarray,
    label_mat: np.ndarray,
    ranks: Sequence[int] = (1,),
    FARs: Sequence[float] = (1.0,),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed/open-set identification (CMC generalized with thresholds).

    score_mat: [P, G]; label_mat: [P, G] bool. Returns (DIRs [F, R]
    squeezed, measured FARs [F], thresholds [F]).
    Mirrors tinyface_helper.py:86-170.
    """
    assert score_mat.shape == label_mat.shape
    match = label_mat.astype(bool).any(axis=1)
    score_m, label_m = score_mat[match], label_mat[match].astype(bool)
    score_nm = score_mat[~match]

    if len(FARs) == 1 and FARs[0] >= 1.0:
        thresholds = np.asarray([np.min(score_mat) - 1e-10])
        openset = False
    else:
        assert score_nm.shape[0] > 0, (
            "open-set identification needs non-mate probes"
        )
        max_nm = np.max(score_nm, axis=1)
        thresholds = find_thresholds_by_FAR(
            max_nm, np.zeros(max_nm.shape, bool), FARs
        )
        openset = True

    order = np.argsort(score_m, axis=1)[:, ::-1]
    sorted_label = np.take_along_axis(label_m, order, axis=1)

    if openset:
        gt_score = score_m[label_m]
        assert gt_score.size == score_m.shape[0]

    DIRs = np.zeros((len(thresholds), len(ranks)), np.float32)
    out_FARs = np.zeros(len(thresholds), np.float32)
    for i, threshold in enumerate(thresholds):
        for j, rank in enumerate(ranks):
            success = sorted_label[:, :rank].any(axis=1)
            if openset:
                DIRs[i, j] = float(
                    ((gt_score >= threshold) & success).mean()
                )
            else:
                DIRs[i, j] = float(success.mean())
        if openset:
            out_FARs[i] = float((np.max(score_nm, 1) >= threshold).mean())
    if DIRs.shape[0] == 1 or DIRs.shape[1] == 1:
        DIRs = DIRs.flatten()
    return DIRs, out_FARs, thresholds


def _l2(x: np.ndarray):
    n = np.linalg.norm(x, ord=2, axis=1, keepdims=True)
    return x / np.clip(n, 1e-12, None), n


FUSION_METHODS = (
    "average",
    "norm_weighted_avg",
    "pre_norm_vector_add",
    "concat",
    "faceness_score",
)


def fuse_features_with_norm(
    stacked_embeddings: np.ndarray,  # [F, B, D]
    stacked_norms: Optional[np.ndarray],  # [F, B, 1] or None
    fusion_method: str = "norm_weighted_avg",
    faceness_scores: Optional[np.ndarray] = None,  # [B]
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip-TTA fusion — validate_tinyface.py:29-65 semantics.

    faceness_score: the reference raises there, pointing at insightface's
    ijb_11.py:296 recipe; implemented here per that recipe — sum the
    flip halves and scale each fused embedding by its detector score,
    with NO re-normalization afterward (the detector confidence becomes
    part of the feature magnitude, down-weighting dubious faces in the
    inner-product scores).
    """
    assert stacked_embeddings.ndim == 3
    if stacked_norms is not None:
        assert stacked_norms.ndim == 3
    else:
        assert fusion_method not in ("norm_weighted_avg", "pre_norm_vector_add")

    def mean_norm_or_ones():
        if stacked_norms is None:
            return np.ones((stacked_embeddings.shape[1], 1), np.float32)
        return stacked_norms.mean(axis=0)

    if fusion_method == "norm_weighted_avg":
        weights = stacked_norms / stacked_norms.sum(axis=0, keepdims=True)
        fused, _ = _l2((stacked_embeddings * weights).sum(axis=0))
        fused_norm = stacked_norms.mean(axis=0)
    elif fusion_method == "pre_norm_vector_add":
        fused, fused_norm = _l2(
            (stacked_embeddings * stacked_norms).sum(axis=0)
        )
    elif fusion_method == "average":
        fused, _ = _l2(stacked_embeddings.sum(axis=0))
        fused_norm = mean_norm_or_ones()
    elif fusion_method == "concat":
        fused = np.concatenate(
            [stacked_embeddings[0], stacked_embeddings[1]], axis=-1
        )
        fused_norm = mean_norm_or_ones()
    elif fusion_method == "faceness_score":
        if faceness_scores is None:
            raise ValueError(
                "faceness_score fusion requires per-image detector scores"
            )
        fused = stacked_embeddings.sum(axis=0) * np.asarray(
            faceness_scores, np.float32
        ).reshape(-1, 1)
        fused_norm = mean_norm_or_ones()
    else:
        raise ValueError(f"not a correct fusion method: {fusion_method!r}")
    return fused, fused_norm


class RankRetrievalTest:
    """TinyFace-style identification: probe vs gallery (+ distractors).

    Mirrors TinyFaceTest.init_proto/test_identification
    (validation_lq/tinyface_helper.py:28-70): gallery = mate gallery +
    distractor set; rank-k accuracy via DIR_FAR at FAR=1.
    """

    def __init__(
        self,
        probe_labels: np.ndarray,
        gallery_labels: np.ndarray,
        num_distractors: int = 0,
    ):
        self.probe_labels = np.asarray(probe_labels)
        g = np.asarray(gallery_labels)
        if num_distractors:
            g = np.concatenate([g, np.full(num_distractors, -100)])
        self.gallery_labels = g

    def identification(
        self,
        probe_features: np.ndarray,
        gallery_features: np.ndarray,
        ranks: Sequence[int] = (1, 5, 20),
    ) -> Dict[int, float]:
        assert gallery_features.shape[0] == self.gallery_labels.shape[0]
        score = inner_product(probe_features, gallery_features)
        label = (
            self.probe_labels[:, None] == self.gallery_labels[None, :]
        )
        DIRs, _, _ = DIR_FAR(score, label, ranks=list(ranks), FARs=[1.0])
        return {r: float(d) for r, d in zip(ranks, np.atleast_1d(DIRs))}
