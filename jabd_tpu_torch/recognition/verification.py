"""Verification evaluation: 10-fold ROC/accuracy + feature fusion.

A copy of `jabd_tpu/recognition/verification.py` (numpy only), with its
own k-fold split in place of sklearn's.

Faithful port of evaluate_utils.py:82-214 (facenet/insightface-style
k-fold verification over distance thresholds) and utils.py:13-29
(l2_norm, fuse_features_with_norm — the flip-TTA norm-weighted fusion
used by train_val.py:77-104).
"""

from __future__ import annotations

import numpy as np


def kfold_splits(n: int, n_splits: int = 10):
    """(train indices, test indices) per fold of 0..n-1 in order, the
    first n % n_splits folds one longer: sklearn's KFold(n_splits,
    shuffle=False)."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"cannot split {n} pairs into {n_splits} folds")
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    indices = np.arange(n)
    lo = 0
    for size in sizes:
        test = indices[lo : lo + size]
        yield np.concatenate([indices[:lo], indices[lo + size :]]), test
        lo += size


def l2_norm(x: np.ndarray, axis: int = 1):
    norm = np.linalg.norm(x, ord=2, axis=axis, keepdims=True)
    return x / norm, norm


def fuse_features_with_norm(
    stacked_embeddings: np.ndarray, stacked_norms: np.ndarray
):
    """[F, B, D] embeddings + [F, B, 1] norms -> norm-weighted sum,
    re-normalized (utils.py:20-29). Thin alias of the general fusion in
    identification.py (its 'pre_norm_vector_add' method is this exact
    recipe) so the computation lives in one place."""
    from jabd_tpu_torch.recognition import identification as ID

    return ID.fuse_features_with_norm(
        stacked_embeddings, stacked_norms, "pre_norm_vector_add"
    )


def calculate_accuracy(threshold, dist, actual_issame):
    predict = np.less(dist, threshold)
    tp = np.sum(np.logical_and(predict, actual_issame))
    fp = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    tn = np.sum(
        np.logical_and(np.logical_not(predict), np.logical_not(actual_issame))
    )
    fn = np.sum(np.logical_and(np.logical_not(predict), actual_issame))
    tpr = 0 if (tp + fn == 0) else float(tp) / float(tp + fn)
    fpr = 0 if (fp + tn == 0) else float(fp) / float(fp + tn)
    acc = float(tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_roc(
    thresholds, embeddings1, embeddings2, actual_issame, nrof_folds=10
):
    assert embeddings1.shape == embeddings2.shape
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    nrof_thresholds = len(thresholds)

    tprs = np.zeros((nrof_folds, nrof_thresholds))
    fprs = np.zeros((nrof_folds, nrof_thresholds))
    accuracy = np.zeros(nrof_folds)
    best_thresholds = np.zeros(nrof_folds)

    diff = embeddings1 - embeddings2
    dist = np.sum(np.square(diff), 1)

    for fold_idx, (train_set, test_set) in enumerate(kfold_splits(nrof_pairs, nrof_folds)):
        acc_train = np.zeros(nrof_thresholds)
        for ti, threshold in enumerate(thresholds):
            _, _, acc_train[ti] = calculate_accuracy(
                threshold, dist[train_set], actual_issame[train_set]
            )
        best = int(np.argmax(acc_train))
        best_thresholds[fold_idx] = thresholds[best]
        for ti, threshold in enumerate(thresholds):
            tprs[fold_idx, ti], fprs[fold_idx, ti], _ = calculate_accuracy(
                threshold, dist[test_set], actual_issame[test_set]
            )
        _, _, accuracy[fold_idx] = calculate_accuracy(
            thresholds[best], dist[test_set], actual_issame[test_set]
        )
    return np.mean(tprs, 0), np.mean(fprs, 0), accuracy, best_thresholds


def calculate_val_far(threshold, dist, actual_issame):
    predict = np.less(dist, threshold)
    true_accept = np.sum(np.logical_and(predict, actual_issame))
    false_accept = np.sum(
        np.logical_and(predict, np.logical_not(actual_issame))
    )
    n_same = np.sum(actual_issame)
    n_diff = np.sum(np.logical_not(actual_issame))
    return (
        float(true_accept) / float(n_same),
        float(false_accept) / float(n_diff),
    )


def calculate_val(
    thresholds, embeddings1, embeddings2, actual_issame, far_target,
    nrof_folds=10,
):
    """TAR @ FAR with per-fold threshold interpolation
    (evaluate_utils.py:155-190)."""
    from scipy import interpolate

    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    dist = np.sum(np.square(embeddings1 - embeddings2), 1)
    for fold_idx, (train_set, test_set) in enumerate(kfold_splits(nrof_pairs, nrof_folds)):
        far_train = np.zeros(len(thresholds))
        for ti, threshold in enumerate(thresholds):
            _, far_train[ti] = calculate_val_far(
                threshold, dist[train_set], actual_issame[train_set]
            )
        if np.max(far_train) >= far_target:
            f = interpolate.interp1d(far_train, thresholds, kind="slinear")
            threshold = f(far_target)
        else:
            threshold = 0.0
        val[fold_idx], far[fold_idx] = calculate_val_far(
            threshold, dist[test_set], actual_issame[test_set]
        )
    return float(np.mean(val)), float(np.std(val)), float(np.mean(far))


def evaluate(embeddings, actual_issame, nrof_folds=10):
    """evaluate_utils.py:207-214: even rows vs odd rows are the pairs."""
    thresholds = np.arange(0, 4, 0.01)
    return calculate_roc(
        thresholds,
        embeddings[0::2],
        embeddings[1::2],
        np.asarray(actual_issame),
        nrof_folds=nrof_folds,
    )
