"""Failed-case miner: the worst false positives / false negatives per
model (the port's copy of the JAX package's ``analysis/failed_cases.py``,
without pandas).

Reference contract (additional_analysis.py:103-181): the top-N FPs are the
live images with the highest spoof scores, the top-N FNs the spoof images
with the lowest (ties in file order, as pandas ``nlargest`` /
``nsmallest``); the images are copied as ``FP_score{s:.4f}_{name}`` /
``FN_score{s:.4f}_{name}`` into ``results/failed_cases_analysis/<model>/
{false_positives,false_negatives}`` with per-model CSVs and a root
``failed_cases_summary.json``.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import numpy as np

from ..eval.single import records_frame, write_csv
from .tables import read_csv

log = logging.getLogger(__name__)


def _top(scores: np.ndarray, rows: np.ndarray, n: int, largest: bool):
    """The ``n`` of ``rows`` with the largest (smallest) score, in that
    order, ties in row order; NaN scores are left out."""
    rows = rows[~np.isnan(scores[rows])]
    key = -scores[rows] if largest else scores[rows]
    return rows[np.argsort(key, kind="stable")[:n]]


def extract_failed_cases(results_dir: str, test_data_dir: str = "",
                         top_n: int = 20) -> dict:
    results = Path(results_dir)
    failed_dir = results / "failed_cases_analysis"
    failed_dir.mkdir(exist_ok=True)
    all_failed = {}

    for model_dir in sorted(p for p in results.iterdir() if p.is_dir()):
        if model_dir.name == "failed_cases_analysis":
            continue
        pred_file = model_dir / "per_image_predictions.csv"
        if not pred_file.exists():
            continue
        df = read_csv(pred_file)
        label, score = df["true_label"], df["spoof_score"].astype(np.float64)
        error = np.abs(label - score)
        pred = (score >= 0.5).astype(int)
        fps = _top(score, np.flatnonzero((label == 0) & (pred == 1)), top_n,
                   largest=True)
        fns = _top(score, np.flatnonzero((label == 1) & (pred == 0)), top_n,
                   largest=False)

        mdir = failed_dir / model_dir.name
        fp_dir = mdir / "false_positives"
        fn_dir = mdir / "false_negatives"
        fp_dir.mkdir(parents=True, exist_ok=True)
        fn_dir.mkdir(parents=True, exist_ok=True)

        def collect(idx, out_dir, prefix, true_label):
            cases = []
            for i in idx:
                src = Path(df["image_path"][i])
                if not src.is_absolute() and test_data_dir:
                    src = Path(test_data_dir) / src
                if not src.exists():
                    # only cases whose image is reachable are recorded
                    # (additional_analysis.py:142-150); total_* counts the
                    # whole top-N
                    continue
                shutil.copy2(src, out_dir /
                             f"{prefix}_score{score[i]:.4f}_{src.name}")
                cases.append({
                    "image": Path(df["image_path"][i]).name,
                    "true_label": true_label,
                    "predicted_score": float(score[i]),
                    "error_magnitude": float(error[i]),
                })
            return cases

        fp_cases = collect(fps, fp_dir, "FP", "live")
        fn_cases = collect(fns, fn_dir, "FN", "spoof")
        all_failed[model_dir.name] = {
            "false_positives": fp_cases,
            "false_negatives": fn_cases,
            "total_fp": len(fps),
            "total_fn": len(fns),
        }
        for cases, name in ((fp_cases, "false_positives.csv"),
                            (fn_cases, "false_negatives.csv")):
            write_csv(mdir / name, records_frame(cases) if cases else {})
        log.info("%s: %d FP / %d FN mined", model_dir.name,
                 len(fp_cases), len(fn_cases))

    with open(failed_dir / "failed_cases_summary.json", "w") as f:
        json.dump(all_failed, f, indent=2)
    return all_failed
