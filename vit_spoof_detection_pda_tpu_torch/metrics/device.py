"""PAD metric reductions on tensors (counterpart of the JAX package's
``metrics/device.py``).

Everything here is a fixed-shape reduction over the score vector on its
own device, so validation keeps the scores on the card and fetches only
the final scalars.  The reference computes these on the host with
scikit-learn (test.py:223-280, evaluate_all_models.py:81-119);
``metrics/parity.py`` is the float64 replica of that.

Conventions
-----------
``labels`` are int {0,1}; ``scores`` are P(label==1).  Which class is
"positive" is a caller decision: the train/test stack uses 1=live with
score=P(live) (reference test.py:117,217) and the cross-model harness uses
1=spoof with score=P(spoof) (reference evaluate_all_models.py:38-42,145).
APCER/BPCER are FAR/FRR of the positive class exactly as written in
evaluate_all_models.py:91-94.  Arithmetic is f32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _t(x, dtype=None, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Confusion counts & derived binary metrics
# --------------------------------------------------------------------------


def confusion_at_thresholds(scores, labels, thresholds):
    """Confusion counts at each threshold, predictions ``score >= t``
    (reference evaluate_all_models.py:82): ``(tp, tn, fp, fn)``, each of
    ``thresholds.shape``, from one broadcast pass over the data."""
    scores = _t(scores)
    labels = _t(labels, device=scores.device)
    thresholds = _t(thresholds, device=scores.device)
    pred = scores[None, :] >= thresholds[..., None]          # [T, N]
    pos = (labels == 1)[None, :]
    tp = (pred & pos).sum(-1)
    fp = (pred & ~pos).sum(-1)
    n_pos = (labels == 1).sum()
    n_neg = labels.shape[0] - n_pos
    return tp, n_neg - fp, fp, n_pos - tp


def _safe_div(num, den):
    """``num / den`` with zero_division=0 semantics."""
    den = den.float()
    return torch.where(den > 0, num / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                       torch.zeros_like(den))


def binary_metrics_from_counts(tp, tn, fp, fn):
    """Derived metrics from confusion counts (zero_division=0): accuracy,
    precision (= ppv), recall, f1, specificity, npv, far (= apcer) =
    fp / (fp + tn), frr (= bpcer) = fn / (fn + tp); reference
    test.py:229-252 and evaluate_all_models.py:86-94."""
    tp, tn, fp, fn = (_t(v, torch.float32) for v in (tp, tn, fp, fn))
    total = tp + tn + fp + fn
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    # sklearn's count form (2tp / (2tp + fp + fn))
    f1 = _safe_div(2 * tp, 2 * tp + fp + fn)
    far = _safe_div(fp, fp + tn)
    frr = _safe_div(fn, fn + tp)
    return {
        "accuracy": _safe_div(tp + tn, total),
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "specificity": _safe_div(tn, tn + fp),
        "npv": _safe_div(tn, tn + fn),
        "ppv": precision,
        "far": far,
        "frr": frr,
        "apcer": far,
        "bpcer": frr,
    }


def threshold_table(scores, labels, thresholds):
    """The threshold-analysis table as a dict of ``[T]`` tensors (the
    metrics at each threshold, the thresholds and the counts)."""
    tp, tn, fp, fn = confusion_at_thresholds(scores, labels, thresholds)
    out = binary_metrics_from_counts(tp, tn, fp, fn)
    out.update(threshold=_t(thresholds, torch.float32, tp.device),
               tp=tp, tn=tn, fp=fp, fn=fn)
    return out


def threshold_grid(t_min: float, t_max: float, steps: int,
                   device=None) -> torch.Tensor:
    """The sweep's ``steps`` thresholds from ``t_min`` to ``t_max`` in f32:
    ``numpy.linspace`` in float64, rounded once.  ``jnp.linspace``'s f32
    arithmetic lands within one f32 ulp of these (its last bit follows
    how XLA fuses ``start (1 - s) + stop s``)."""
    grid = np.linspace(t_min, t_max, steps).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def optimal_threshold_f1(scores, labels, t_min=0.3, t_max=0.7, steps=41):
    """Max-F1 threshold sweep (reference train_advanced.py:239-278):
    ``(best_threshold, best_f1, table)``.  The first maximum wins; when
    the whole sweep has F1 == 0 the threshold is 0.5, as the reference
    initializes it and updates only on a strictly greater F1."""
    scores = _t(scores)
    grid = threshold_grid(t_min, t_max, steps, scores.device)
    table = threshold_table(scores, labels, grid)
    idx = torch.argmax(table["f1_score"])
    best_f1 = table["f1_score"][idx]
    best_t = torch.where(best_f1 > 0, grid[idx],
                         torch.tensor(0.5, dtype=torch.float32,
                                      device=grid.device))
    return best_t, best_f1, table


# --------------------------------------------------------------------------
# ROC curve with static shapes + validity masks
# --------------------------------------------------------------------------


class MaskedRoc(NamedTuple):
    """ROC curve of length N+1 with a validity mask: slot 0 is sklearn's
    synthetic ``(fpr=0, tpr=0, threshold=inf)`` point; slots 1..N follow
    the descending-score order and are valid at distinct-threshold
    boundaries (and, with ``drop_intermediate``, only at non-collinear
    corners: exactly sklearn's ``roc_curve`` point set)."""

    fpr: torch.Tensor
    tpr: torch.Tensor
    thresholds: torch.Tensor
    valid: torch.Tensor


def masked_roc(scores, labels, *, drop_intermediate: bool = True) -> MaskedRoc:
    """sklearn-semantics ROC curve with static shapes (reference
    test.py:254, evaluate_all_models.py:114): stable descending sort,
    cumulative tp / fp at distinct thresholds, sklearn's collinear-point
    dropping by the second-difference test, the prepended inf point.
    A class that is absent makes every rate NaN, as sklearn's division
    does."""
    scores = _t(scores, torch.float32)
    labels = _t(labels, device=scores.device)
    n = scores.shape[0]
    dev = scores.device

    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    y = (labels[order] == 1).float()
    tps = torch.cumsum(y, 0)
    idx1 = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    fps = idx1 - tps
    is_last = torch.cat([s[:-1] != s[1:], torch.ones(1, dtype=torch.bool,
                                                     device=dev)])

    if drop_intermediate and n > 2:
        pos = torch.arange(n, device=dev)
        prev_seq = torch.where(is_last, pos, torch.full_like(pos, -1))
        prev_idx = torch.cat([torch.full((1,), -1, dtype=pos.dtype,
                                         device=dev),
                              torch.cummax(prev_seq, 0).values[:-1]])
        next_seq = torch.where(is_last, pos, torch.full_like(pos, n))
        next_idx = torch.cat([
            torch.cummin(next_seq.flip(0), 0).values.flip(0)[1:],
            torch.full((1,), n, dtype=pos.dtype, device=dev)])
        has_prev, has_next = prev_idx >= 0, next_idx < n
        p = prev_idx.clamp(0, n - 1)
        nx = next_idx.clamp(0, n - 1)
        d2_fps = (fps[nx] - fps) - (fps - fps[p])
        d2_tps = (tps[nx] - tps) - (tps - tps[p])
        corner = (d2_fps != 0) | (d2_tps != 0)
        keep = is_last & (~has_prev | ~has_next | corner)
    else:
        keep = is_last

    n_pos, n_neg = tps[-1], fps[-1]
    zero = torch.zeros(1, device=dev)
    nan = torch.tensor(float("nan"), device=dev)
    fpr = torch.where(n_neg > 0, torch.cat([zero, _safe_div(fps, n_neg)]),
                      nan)
    tpr = torch.where(n_pos > 0, torch.cat([zero, _safe_div(tps, n_pos)]),
                      nan)
    thr = torch.cat([torch.full((1,), float("inf"), device=dev), s])
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), keep])
    return MaskedRoc(fpr, tpr, thr, valid)


# --------------------------------------------------------------------------
# AUC (rank statistic: exact under ties)
# --------------------------------------------------------------------------


def auc(scores, labels):
    """ROC-AUC as the Mann-Whitney rank statistic with tie correction
    (equal to sklearn's trapezoidal ``roc_auc_score``, reference
    test.py:235): one sort and two searchsorted passes.  0 when a class
    is absent."""
    scores = _t(scores, torch.float32)
    pos = _t(labels, device=scores.device) == 1
    s_sorted = torch.sort(scores).values
    first = torch.searchsorted(s_sorted, scores, side="left").float()
    last = torch.searchsorted(s_sorted, scores, side="right").float()
    avg_rank = (first + last + 1.0) / 2.0             # 1-based average ranks
    n_pos = pos.float().sum()
    n_neg = scores.shape[0] - n_pos
    rank_sum = torch.where(pos, avg_rank, torch.zeros_like(avg_rank)).sum()
    u = rank_sum - n_pos * (n_pos + 1.0) / 2.0
    ok = (n_pos > 0) & (n_neg > 0)
    return torch.where(ok, u / torch.where(ok, n_pos * n_neg,
                                           torch.ones_like(n_pos)),
                       torch.zeros_like(u))


# --------------------------------------------------------------------------
# EER: both reference flavors
# --------------------------------------------------------------------------


def eer_mean(scores, labels):
    """EER as (fpr + fnr) / 2 at argmin |fnr - fpr| (reference
    test.py:253-257)."""
    roc = masked_roc(scores, labels, drop_intermediate=True)
    fnr = 1.0 - roc.tpr
    gap = torch.where(roc.valid, (fnr - roc.fpr).abs(),
                      torch.full_like(fnr, float("inf")))
    i = _argmin_nan(gap)
    return (roc.fpr[i] + fnr[i]) / 2.0


def eer_harness(scores, labels):
    """``(eer, threshold)`` with eer = fpr at the EER index (reference
    evaluate_all_models.py:113-119)."""
    roc = masked_roc(scores, labels, drop_intermediate=True)
    fnr = 1.0 - roc.tpr
    gap = torch.where(roc.valid, (roc.fpr - fnr).abs(),
                      torch.full_like(fnr, float("inf")))
    i = _argmin_nan(gap)
    return roc.fpr[i], roc.thresholds[i]


def _argmin_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin``: the first minimum, and the first NaN if any (NaN
    compares as the minimum there), so single-class input lands on index
    0 as ``np.argmin`` does in the parity path."""
    nan = torch.isnan(x)
    return torch.where(nan.any(), torch.argmax(nan.int()), torch.argmin(
        torch.where(nan, torch.full_like(x, float("inf")), x)))
