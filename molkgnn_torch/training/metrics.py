"""Virtual-screening evaluation metrics, in numpy alone.

Port of ``molkgnn_tpu/training/metrics.py``, which calls scikit-learn; the
port has its own copies of the pieces it used, so that it needs no
scikit-learn:

  * ``roc_curve`` as sklearn's, with ``drop_intermediate=True``: one point
    per distinct score (ties share a point), collinear points between
    corners dropped, (0, 0) prepended, and NaN rates when a class is
    absent. logAUC integrates over log10(FPR) with the trapezoid rule, so
    the dropped points change its value and must match.
  * ``calculate_auc`` is ``roc_auc_score`` on binary labels (the larger
    label is positive) with the reference's -1 fallback wherever sklearn
    refuses the input: a single class, more than two classes, or a
    non-finite score.
  * PPV, accuracy and F1 count the 0.5-cutoff predictions of the sigmoid as
    sklearn's ``confusion_matrix`` and ``f1_score`` do (F1 0 where its
    denominator is 0).

``logAUC[a, b]``: area under the ROC curve plotted against log10(FPR),
restricted to FPR in [a, b] and normalized by log10(b) - log10(a).
"""

from __future__ import annotations

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically stable two-branch sigmoid (exp only sees x <= 0)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def roc_curve(true_y: np.ndarray, score: np.ndarray, pos_label=1):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` gives them
    with its defaults; raises ValueError on a non-finite score."""
    y = np.asarray(true_y).ravel()
    s = np.asarray(score).ravel()
    if y.shape != s.shape:
        raise ValueError(f"lengths differ: {y.shape} and {s.shape}")
    if not (np.all(np.isfinite(s)) and np.all(np.isfinite(y))):
        raise ValueError("input contains NaN or infinity")
    y = (y == pos_label).astype(np.float64)
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order]
    thresh_idx = np.concatenate([np.nonzero(np.diff(s))[0], [y.size - 1]])
    tps = np.cumsum(y)[thresh_idx]
    fps = 1 + thresh_idx.astype(np.float64) - tps
    thresholds = s[thresh_idx]
    if fps.shape[0] > 2:
        keep = np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]
        )
        keep = np.nonzero(keep)[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoid area under y(x), x monotonic (``sklearn.metrics.auc``)."""
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute an area")
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError("x is neither increasing nor decreasing")
        direction = -1.0
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def calculate_logAUC(
    true_y: np.ndarray,
    predicted_score: np.ndarray,
    FPR_range=(0.001, 0.1),
) -> float:
    if FPR_range is None:
        raise ValueError("FPR range cannot be None")
    lo, hi = FPR_range
    if lo >= hi:
        raise ValueError("FPR upper_bound must be greater than lower_bound")

    with np.errstate(divide="ignore"):
        fpr, tpr, _ = roc_curve(true_y, predicted_score, pos_label=1)
        tpr = np.append(tpr, np.interp([lo, hi], fpr, tpr))
        fpr = np.append(fpr, [lo, hi])
        tpr = np.sort(tpr)
        fpr = np.sort(fpr)
        x = np.log10(fpr)
        y = tpr
        log_lo, log_hi = np.log10(lo), np.log10(hi)

    lo_idx = np.where(x == log_lo)[-1][-1]
    hi_idx = np.where(x == log_hi)[-1][-1]
    trim_x = x[lo_idx : hi_idx + 1]
    trim_y = y[lo_idx : hi_idx + 1]
    return float(_auc(trim_x, trim_y) / (log_hi - log_lo))


def calculate_auc(true_y: np.ndarray, predicted_score: np.ndarray) -> float:
    """ROC AUC with the reference's -1 fallback."""
    y = np.asarray(true_y).ravel()
    labels = np.unique(y)
    if (
        labels.size != 2
        or not np.all(labels == np.round(labels))
        or y.shape != np.shape(np.ravel(predicted_score))
        or not np.all(np.isfinite(predicted_score))
    ):
        return -1.0
    fpr, tpr, _ = roc_curve(y, predicted_score, pos_label=labels[1])
    return _auc(fpr, tpr)


def _counts(true_y, predicted_score, cutoff=0.5):
    """(tn, fp, fn, tp) of the sigmoid's cutoff predictions."""
    t = np.asarray(true_y).ravel() == 1
    p = sigmoid(predicted_score).ravel() > cutoff
    return (
        int(np.sum(~t & ~p)), int(np.sum(~t & p)),
        int(np.sum(t & ~p)), int(np.sum(t & p)),
    )


def calculate_ppv(
    true_y: np.ndarray, predicted_score: np.ndarray, cutoff: float = 0.5
) -> float:
    _, fp, _, tp = _counts(true_y, predicted_score, cutoff)
    return float(tp / (tp + fp)) if (tp + fp) != 0 else float("nan")


def calculate_accuracy(
    true_y: np.ndarray, predicted_score: np.ndarray
) -> float:
    tn, fp, fn, tp = _counts(true_y, predicted_score)
    total = tp + fp + tn + fn
    return float((tp + tn) / total) if total != 0 else float("nan")


def calculate_f1_score(
    true_y: np.ndarray, predicted_score: np.ndarray
) -> float:
    _, fp, fn, tp = _counts(true_y, predicted_score)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom != 0 else 0.0


def compute_metrics(metrics: list, true_y: np.ndarray, pred_y: np.ndarray) -> dict:
    """Metric-name dispatch; the keys drive the checkpoint monitors."""
    out = {}
    for metric in metrics:
        if metric == "accuracy":
            out["accuracy"] = calculate_accuracy(true_y, pred_y)
        elif metric == "RMSE":
            out["RMSE"] = float(np.sqrt(np.mean((true_y - pred_y) ** 2)))
        elif metric == "logAUC_0.001_0.1":
            out["logAUC_0.001_0.1"] = calculate_logAUC(true_y, pred_y)
        elif metric == "logAUC_0.001_1":
            out["logAUC_0.001_1"] = calculate_logAUC(
                true_y, pred_y, FPR_range=(0.001, 1)
            )
        elif metric == "ppv":
            out["ppv"] = calculate_ppv(true_y, pred_y)
        elif metric == "f1_score":
            out["f1_score"] = calculate_f1_score(true_y, pred_y)
        elif metric == "AUC":
            out["AUC"] = calculate_auc(true_y, pred_y)
        else:
            raise ValueError(f"unknown metric {metric}")
    return out
