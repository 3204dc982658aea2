"""Probability calibration of PAD scores (the port's copy of the JAX
package's ``analysis/calibration.py``, numpy only).

Over the harness's ``per_image_predictions.csv`` artifacts (0 = live /
1 = spoof, ``spoof_score`` = P(spoof)):

- :func:`reliability_curve`: sklearn ``calibration_curve`` semantics
  (uniform or quantile bins, empty bins dropped) plus per-bin counts;
- :func:`calibration_errors`: ECE / MCE (count-weighted / max ``|accuracy
  - confidence|`` over the bins), Brier score and NLL;
- :func:`fit_temperature` / :func:`apply_temperature`: temperature scaling
  (Guo et al. 2017), one scalar T fitted by Newton's method on the NLL of
  ``sigmoid(logit(p) / T)``; monotone, so AUC, EER and every threshold
  ranking are unchanged.

The score must be the model's probability of ``label == 1``.
:func:`analyze_calibration` writes ``<model>/calibration_curve.csv`` (the
bytes pandas would write) and ``calibration_analysis.json``;
:func:`plot_reliability_diagram` needs matplotlib, imported when called.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from ..eval.single import write_csv
from .tables import read_csv

log = logging.getLogger(__name__)

_EPS = 1e-12


def reliability_curve(scores, labels, *, n_bins: int = 15,
                      strategy: str = "uniform"):
    """``(prob_true, prob_pred, counts)`` per non-empty bin: sklearn's
    ``calibration_curve`` (uniform: ``n_bins`` equal-width bins over [0, 1],
    right-closed; quantile: score-percentile edges) plus each bin's
    population."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    if scores.shape != labels.shape:
        raise ValueError(f"scores {scores.shape} vs labels "
                         f"{labels.shape}")
    if scores.size == 0:
        raise ValueError("empty score vector")
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if strategy == "uniform":
        edges = np.linspace(0.0, 1.0, n_bins + 1)
    elif strategy == "quantile":
        # linspace(0, 1) * 100, not linspace(0, 100): the edges' last ulp
        # moves boundary samples across bins
        edges = np.percentile(scores,
                              np.linspace(0.0, 1.0, n_bins + 1) * 100)
    else:
        raise ValueError(f"strategy must be 'uniform' or 'quantile', "
                         f"got {strategy!r}")
    ids = np.searchsorted(edges[1:-1], scores)
    counts = np.bincount(ids, minlength=n_bins)
    sums_p = np.bincount(ids, weights=scores, minlength=n_bins)
    sums_y = np.bincount(ids, weights=labels.astype(np.float64),
                         minlength=n_bins)
    nonzero = counts > 0
    prob_true = sums_y[nonzero] / counts[nonzero]
    prob_pred = sums_p[nonzero] / counts[nonzero]
    return prob_true, prob_pred, counts[nonzero]


def _errors_from_curve(curve, scores, labels) -> dict:
    prob_true, prob_pred, counts = curve
    gap = np.abs(prob_true - prob_pred)
    p = np.clip(scores, _EPS, 1.0 - _EPS)
    return {
        "ece": float(np.sum(gap * counts) / np.sum(counts)),
        "mce": float(np.max(gap)),
        "brier": float(np.mean((scores - labels) ** 2)),
        "nll": float(-np.mean(labels * np.log(p)
                              + (1 - labels) * np.log1p(-p))),
    }


def calibration_errors(scores, labels, *, n_bins: int = 15,
                       strategy: str = "uniform") -> dict:
    """``{"ece", "mce", "brier", "nll"}`` of P(label == 1) scores."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    curve = reliability_curve(scores, labels, n_bins=n_bins,
                              strategy=strategy)
    return _errors_from_curve(curve, scores, labels)


def fit_temperature(scores, labels, *, max_iter: int = 100,
                    tol: float = 1e-10) -> float:
    """The NLL-optimal T for ``sigmoid(logit(p) / T)``, by Newton's method
    on ``s = 1 / T``, where the binary NLL is strictly convex, from
    ``s = 1``.  T > 1 softens over-confident scores, T < 1 sharpens."""
    p = np.clip(np.asarray(scores, np.float64), _EPS, 1.0 - _EPS)
    y = np.asarray(labels, np.float64)
    z = np.log(p) - np.log1p(-p)
    s = 1.0
    for _ in range(max_iter):
        q = 1.0 / (1.0 + np.exp(-s * z))
        grad = float(np.mean((q - y) * z))
        hess = float(np.mean(q * (1.0 - q) * z * z))
        if hess <= 0:               # all-identical scores: nothing to fit
            break
        s_new = s - grad / hess
        if s_new <= 0:              # convex: halve toward zero instead
            s_new = s / 2.0
        if abs(s_new - s) < tol:
            s = s_new
            break
        s = s_new
    return float(1.0 / s)


def apply_temperature(scores, temperature: float):
    """Rescale probabilities through ``sigmoid(logit(p) / T)`` in float64
    (monotone — rankings, AUC and EER are invariant)."""
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    p = np.clip(np.asarray(scores, np.float64), _EPS, 1.0 - _EPS)
    z = (np.log(p) - np.log1p(-p)) / float(temperature)
    return 1.0 / (1.0 + np.exp(-z))


def analyze_calibration(results_dir: str, *, n_bins: int = 15,
                        strategy: str = "uniform") -> dict:
    """Per-model calibration over ``<results_dir>/<model>/
    per_image_predictions.csv``: each model's bin table to
    ``<model>/calibration_curve.csv``, and the errors before and after
    temperature scaling with the fitted T to
    ``<results_dir>/calibration_analysis.json``.  Models with one class
    are skipped with a warning."""
    results = Path(results_dir)
    report = {}
    for model_dir in sorted(p for p in results.iterdir() if p.is_dir()):
        pred_file = model_dir / "per_image_predictions.csv"
        if not pred_file.exists():
            continue
        df = read_csv(pred_file)
        labels = df["true_label"]
        scores = df["spoof_score"].astype(np.float64)
        if len(np.unique(labels)) < 2:
            log.warning("%s: one class only — skipping calibration",
                        model_dir.name)
            continue
        prob_true, prob_pred, counts = curve = reliability_curve(
            scores, labels, n_bins=n_bins, strategy=strategy)
        errors = _errors_from_curve(curve, scores,
                                    labels.astype(np.float64))
        temperature = fit_temperature(scores, labels)
        after = calibration_errors(apply_temperature(scores, temperature),
                                   labels, n_bins=n_bins, strategy=strategy)
        write_csv(model_dir / "calibration_curve.csv", {
            "mean_predicted_prob": prob_pred,
            "observed_frequency": prob_true,
            "count": counts})
        report[model_dir.name] = {
            "n_bins": int(n_bins),
            "strategy": strategy,
            "before": errors,
            "temperature": float(temperature),
            "after": after,
        }
        log.info("%s: ECE %.4f -> %.4f (T=%.3f)", model_dir.name,
                 errors["ece"], after["ece"], temperature)
    (results / "calibration_analysis.json").write_text(
        json.dumps(report, indent=2))
    return report


def plot_reliability_diagram(results_dir: str, out_path=None):
    """One reliability diagram across every model with a
    ``calibration_curve.csv`` (run :func:`analyze_calibration` first):
    the figure's path, or None when nothing is plottable.  Needs
    matplotlib (``ImportError`` without it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = Path(results_dir)
    curves = sorted(results.glob("*/calibration_curve.csv"))
    if not curves:
        return None
    out_path = Path(out_path or results / "calibration_reliability.png")
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "k--", lw=1, label="perfect calibration")
    for f in curves:
        df = read_csv(f)
        ax.plot(df["mean_predicted_prob"], df["observed_frequency"],
                marker="o", ms=4, lw=1.5, label=f.parent.name)
    ax.set_xlabel("Mean predicted P(spoof)")
    ax.set_ylabel("Observed spoof frequency")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title("Reliability diagram")
    ax.legend(fontsize=8, loc="best")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return str(out_path)
