"""Binary precision-recall curve and the operating-point metrics the KWS
evals read (a numpy-only copy of enhance_cb_whisper_tpu/metrics/pr_curve.py,
paper 2's best-F search and recall@k included).

Numpy reimplementation of the exact computation the reference gets from
``torchmetrics.PrecisionRecallCurve(task='binary')`` with no fixed threshold
grid (reference: src/model/model.py:76,273-284 and
src/efficient_kws/model.py:127,466-517), which itself mirrors
sklearn's ``precision_recall_curve``:

* thresholds are the distinct prediction scores, ascending;
* ``precision[i]``/``recall[i]`` are computed by predicting positive for
  scores ``>= thresholds[i]``;
* the curve is truncated after full recall is first attained and a final
  (precision=1, recall=0) point is appended.

The reference reads its operating point as
``idx = (thresholds < t).sum()`` — i.e. the smallest threshold >= t —
(src/model/model.py:279-284, src/efficient_kws/model.py:806-839), which
we reproduce in :func:`operating_point`.
"""

from __future__ import annotations

import numpy as np


def binary_pr_curve(preds, target):
    """Returns ``(precision, recall, thresholds)`` as float32/float32/input-dtype.

    preds: [N] scores (any real values; the reference passes sigmoided or
    softmaxed probabilities). target: [N] {0,1}.
    """
    preds = np.asarray(preds)
    target = np.asarray(target)
    assert preds.shape == target.shape and preds.ndim == 1

    order = np.argsort(-preds, kind="stable")
    preds_s = preds[order]
    target_s = target[order]

    # indices where the score changes (last occurrence of each distinct score)
    distinct = np.where(np.diff(preds_s))[0]
    threshold_idxs = np.concatenate([distinct, [preds_s.size - 1]])

    tps = np.cumsum(target_s)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs) - tps
    thresholds = preds_s[threshold_idxs]

    denom = tps + fps
    precision = np.divide(tps, denom, out=np.zeros_like(tps), where=denom > 0)
    total_pos = tps[-1]
    recall = (
        np.divide(tps, total_pos, out=np.ones_like(tps), where=total_pos > 0)
        if total_pos > 0
        else np.ones_like(tps)
    )

    # truncate once full recall is attained, reverse, append the (1, 0) point
    last_ind = int(np.searchsorted(tps, tps[-1]))
    sl = slice(last_ind + 1)
    precision = np.concatenate([precision[sl][::-1], [1.0]])
    recall = np.concatenate([recall[sl][::-1], [0.0]])
    thresholds = thresholds[sl][::-1]
    return precision, recall, thresholds


def operating_point(precision, recall, thresholds, threshold: float = 0.5):
    """(P, R) at the reference's operating-point index: smallest curve
    threshold >= ``threshold`` (src/model/model.py:279-284)."""
    idx = int(np.sum(np.asarray(thresholds) < threshold))
    return float(precision[idx]), float(recall[idx])


def prf_at_threshold(preds, target, threshold: float = 0.5):
    """(precision, recall, f1) at the given operating threshold, with the
    reference's zero-guard f1 (f1 = 0 if either P or R is exactly 0)."""
    precision, recall, thresholds = binary_pr_curve(preds, target)
    p, r = operating_point(precision, recall, thresholds, threshold)
    f1 = 2 * p * r / (p + r) if (p != 0 and r != 0) else 0.0
    return p, r, f1


def find_best_threshold_idx(precision, recall):
    """Index of the best operating point under the reference's weighted
    F-score ``5PR / (4P + R)`` (src/efficient_kws/model.py:669-682)."""
    precision = np.asarray(precision, dtype=np.float64)
    recall = np.asarray(recall, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = (5.0 * precision * recall) / (4.0 * precision + recall)
    scores = np.nan_to_num(scores, nan=0.0)
    return int(np.argmax(scores))


def recall_at_k(preds, target, k: int):
    """Fraction of positive targets ranked in the top-k scores.

    Mirrors src/efficient_kws/model.py:519-544: per utterance, count gold
    keywords whose index appears among the k highest-scoring keywords,
    divided by the number of gold keywords; returns -1.0 when the utterance
    has no positives (the caller averages only non-negative values).
    """
    preds = np.asarray(preds)
    target = np.asarray(target)
    n_pos = target.sum()
    if n_pos <= 0:
        return -1.0
    k = min(int(k), preds.size)
    top_idx = np.argpartition(-preds, k - 1)[:k]
    top_set = set(top_idx.tolist())
    hits = sum(1 for i in np.nonzero(target)[0] if int(i) in top_set)
    return float(hits) / float(n_pos)
