"""sklearn-exact NumPy metric implementations (the port's own copy of the
JAX package's ``metrics/parity.py``, numpy only).

The reference computes its metrics with scikit-learn on host
(test.py:223-280; testing_set_analysis_src/evaluate_all_models.py:81-119).
This module re-implements exactly those code paths in float64 NumPy —
without importing sklearn — so the published numbers replay bit-for-bit
against the reference's golden artifacts.  The eval artifacts
(``eval/single.py``, ``eval/harness.py``) are computed with it, on the
gathered score vector on the host.
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# sklearn primitive replicas
# --------------------------------------------------------------------------


def _binary_clf_curve(y_true, y_score):
    """fps/tps cumulative counts at distinct thresholds, descending.

    Replicates sklearn's confusion-curve core: stable mergesort descending,
    distinct-threshold boundary selection via diff.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = (y_true[desc] == 1).astype(np.float64)

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def np_roc_curve(y_true, y_score, *, drop_intermediate=True):
    """Replica of sklearn.metrics.roc_curve (>=1.3 semantics: thresholds[0]
    is np.inf and the curve starts at (0,0))."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)

    if drop_intermediate and fps.shape[0] > 2:
        optimal_idxs = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps = fps[optimal_idxs]
        tps = tps[optimal_idxs]
        thresholds = thresholds[optimal_idxs]

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def np_auc_trapezoid(x, y):
    """Replica of sklearn.metrics.auc: trapezoid over a monotone curve."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    direction = 1.0
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    # np.trapezoid is numpy>=2 (same math as the 1.x trapz)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(direction * trapezoid(y, x))


def np_roc_auc_score(y_true, y_score):
    """Replica of sklearn.metrics.roc_auc_score (binary path): trapezoid on
    the drop_intermediate curve — bitwise what the reference stores."""
    if len(np.unique(np.asarray(y_true))) != 2:
        return float("nan")
    fpr, tpr, _ = np_roc_curve(y_true, y_score)
    return np_auc_trapezoid(fpr, tpr)


def _confusion_counts(y_true, y_pred):
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    return tn, fp, fn, tp


def _prf_binary(tp, fp, fn):
    """precision/recall/f1 with sklearn zero_division=0 semantics.

    f1 uses sklearn's count form ``2*tp / (2*tp + fp + fn)`` (its
    precision_recall_fscore_support computes ``(1+b^2)*tp_sum /
    (b^2*true_sum + pred_sum)``), NOT the algebraically-equal
    ``2PR/(P+R)`` — the two round differently in the last float64 ulp
    (e.g. tp=1, fp=4, fn=0: 0.33333333333333337 vs sklearn's
    0.3333333333333333; found by hypothesis), and both reference call
    sites go through sklearn (test.py:231, evaluate_all_models.py:89).
    """
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    denom = float(2 * tp + fp + fn)
    f1 = 2.0 * tp / denom if denom > 0 else 0.0
    return precision, recall, f1


# --------------------------------------------------------------------------
# Reference API flavor 1: test.py:223-280 (`calculate_metrics`)
# --------------------------------------------------------------------------


def calculate_metrics(y_true, y_pred, y_prob):
    """Comprehensive single-threshold metrics, reference test.py:223-280.

    Convention here: 1 = live, ``y_prob`` = P(live) (test.py:117, 217).
    Returns ``(metrics_dict, confusion_matrix_2x2)``.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    y_prob = np.asarray(y_prob, dtype=np.float64)

    tn, fp, fn, tp = _confusion_counts(y_true, y_pred)
    accuracy = (tp + tn) / len(y_true)
    precision, recall, f1 = _prf_binary(tp, fp, fn)

    try:
        auc_val = np_roc_auc_score(y_true, y_prob)
        if np.isnan(auc_val):
            auc_val = 0.0
    except Exception:
        auc_val = 0.0

    specificity = tn / (tn + fp) if (tn + fp) > 0 else 0
    npv = tn / (tn + fn) if (tn + fn) > 0 else 0
    ppv = tp / (tp + fp) if (tp + fp) > 0 else 0
    far = fp / (fp + tn) if (fp + tn) > 0 else 0
    frr = fn / (fn + tp) if (fn + tp) > 0 else 0

    # EER: argmin |fnr-fpr| over the (drop_intermediate) curve, then the
    # mean of the two rates at that index (test.py:253-257).
    fpr, tpr, _ = np_roc_curve(y_true, y_prob)
    fnr = 1 - tpr
    gap = np.absolute(fnr - fpr)
    if np.all(np.isnan(gap)):
        # Single-class y_true: ROC undefined. The reference would crash
        # here (np.nanargmin of all-NaN, test.py:255); degrade to NaN.
        eer = float("nan")
    else:
        eer_idx = np.nanargmin(gap)
        eer = (fpr[eer_idx] + fnr[eer_idx]) / 2

    cm = np.array([[tn, fp], [fn, tp]], dtype=np.int64)
    metrics = {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "auc": auc_val,
        "specificity": specificity,
        "npv": npv,
        "ppv": ppv,
        "far": far,
        "frr": frr,
        "eer": eer,
        "tp": tp,
        "tn": tn,
        "fp": fp,
        "fn": fn,
        "total_samples": len(y_true),
        "live_samples": int(np.sum(y_true)),
        "spoof_samples": int(len(y_true) - np.sum(y_true)),
    }
    return metrics, cm


# --------------------------------------------------------------------------
# Reference API flavor 2: evaluate_all_models.py:81-119 (harness)
# --------------------------------------------------------------------------


def calculate_metrics_at_threshold(y_true, y_scores, threshold):
    """Threshold-table row, reference evaluate_all_models.py:81-110.

    Convention here: 1 = spoof, ``y_scores`` = P(spoof)
    (evaluate_all_models.py:38-42, 145); APCER = FAR of spoof-positive,
    BPCER = FRR (lines 91-94).
    """
    y_true = np.asarray(y_true)
    y_scores = np.asarray(y_scores, dtype=np.float64)
    y_pred = (y_scores >= threshold).astype(int)

    tn, fp, fn, tp = _confusion_counts(y_true, y_pred)
    accuracy = (tp + tn) / len(y_true)
    precision, recall, f1 = _prf_binary(tp, fp, fn)
    apcer = fp / (fp + tn) if (fp + tn) > 0 else 0
    bpcer = fn / (fn + tp) if (fn + tp) > 0 else 0

    return {
        "threshold": threshold,
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "apcer": apcer,
        "bpcer": bpcer,
        "far": apcer,
        "frr": bpcer,
        "tp": tp,
        "tn": tn,
        "fp": fp,
        "fn": fn,
    }


def find_eer_threshold(y_true, y_scores):
    """(eer, threshold) with eer = fpr at argmin |fpr-fnr|
    (reference evaluate_all_models.py:113-119)."""
    fpr, tpr, thresholds = np_roc_curve(y_true, y_scores)
    fnr = 1 - tpr
    eer_idx = np.argmin(np.abs(fpr - fnr))
    return float(fpr[eer_idx]), float(thresholds[eer_idx])
