"""Score-distribution analyzer (the port's copy of the JAX package's
``analysis/distributions.py``, without pandas).

Reads each model's ``per_image_predictions.csv`` (true_label 0 = live /
1 = spoof, spoof_score) and writes per-model ``score_distributions.csv``
plus ``score_distribution_analysis.json`` and
``score_separation_comparison.csv`` at the results root, the reference
analyzer's file contract and statistics (additional_analysis.py:16-100):
per-class mean/std/median/min/max/q25/q75, separation = spoof_mean -
live_mean, Cohen's d with the pooled population std, overlap % = (live
above the spoof median + spoof below the live median) / total.  The CSVs
are the bytes pandas would write (``eval/single.py::write_csv``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from ..eval.single import write_csv
from .tables import read_csv

log = logging.getLogger(__name__)


def _class_stats(scores: np.ndarray) -> dict:
    return {
        "mean": float(np.mean(scores)),
        "std": float(np.std(scores)),
        "median": float(np.median(scores)),
        "min": float(np.min(scores)),
        "max": float(np.max(scores)),
        "q25": float(np.percentile(scores, 25)),
        "q75": float(np.percentile(scores, 75)),
    }


def analyze_score_distributions(results_dir: str) -> dict:
    results = Path(results_dir)
    all_distributions = {}

    for model_dir in sorted(p for p in results.iterdir() if p.is_dir()):
        pred_file = model_dir / "per_image_predictions.csv"
        if not pred_file.exists():
            continue
        df = read_csv(pred_file)
        live = df["spoof_score"][df["true_label"] == 0]
        spoof = df["spoof_score"][df["true_label"] == 1]
        if len(live) == 0 or len(spoof) == 0:
            log.warning("%s: one class empty — skipping", model_dir.name)
            continue

        overlap = (int(np.sum(live > np.median(spoof))) +
                   int(np.sum(spoof < np.median(live))))
        total = len(live) + len(spoof)
        pooled = np.sqrt((np.std(spoof) ** 2 + np.std(live) ** 2) / 2)

        stats = {
            "model_name": model_dir.name,
            "live_scores": _class_stats(live),
            "spoof_scores": _class_stats(spoof),
            "separation_metrics": {
                "mean_difference": float(np.mean(spoof) - np.mean(live)),
                "cohen_d": float((np.mean(spoof) - np.mean(live)) /
                                 pooled) if pooled > 0 else 0.0,
                "overlap_percentage": float(overlap / total * 100),
            },
        }
        all_distributions[model_dir.name] = stats

        write_csv(model_dir / "score_distributions.csv", {
            "score": np.concatenate([live, spoof]),
            "label": ["live"] * len(live) + ["spoof"] * len(spoof),
            "label_numeric": [0] * len(live) + [1] * len(spoof),
        })

        log.info("%s: live mean=%.4f spoof mean=%.4f separation=%.4f",
                 model_dir.name, stats["live_scores"]["mean"],
                 stats["spoof_scores"]["mean"],
                 stats["separation_metrics"]["mean_difference"])

    with open(results / "score_distribution_analysis.json", "w") as f:
        json.dump(all_distributions, f, indent=2)

    if not all_distributions:          # nothing evaluated yet: no
        return all_distributions       # comparison CSV to write

    # largest Cohen's d first, ties in model order (pandas sort_values)
    rows = list(all_distributions.values())
    cohen = np.array([d["separation_metrics"]["cohen_d"] for d in rows])
    rows = [rows[i] for i in np.argsort(-cohen, kind="stable")]
    write_csv(results / "score_separation_comparison.csv", {
        "model": [d["model_name"] for d in rows],
        "live_mean": [d["live_scores"]["mean"] for d in rows],
        "spoof_mean": [d["spoof_scores"]["mean"] for d in rows],
        "mean_diff": [d["separation_metrics"]["mean_difference"]
                      for d in rows],
        "cohen_d": [d["separation_metrics"]["cohen_d"] for d in rows],
        "overlap_pct": [d["separation_metrics"]["overlap_percentage"]
                        for d in rows],
    })
    return all_distributions
