"""Final summary (the port's copy of the JAX package's
``analysis/summary.py``, reference additional_analysis.py:318-354): the
best performers and the performance ranges of ``model_comparison.csv``
into ``final_summary.json``."""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path

import numpy as np

from .tables import read_csv

log = logging.getLogger(__name__)


def generate_summary_statistics(results_dir: str) -> dict:
    """Raises ``FileNotFoundError`` without ``model_comparison.csv``."""
    results = Path(results_dir)
    df = read_csv(results / "model_comparison.csv")
    names = df["model_name"]

    def best(column, pick):
        values = df[column].astype(np.float64)
        return {"model": str(names[pick(values)]),
                "value": float(np.nanmax(values) if pick is np.nanargmax
                               else np.nanmin(values))}

    def span(column):
        values = df[column].astype(np.float64)
        return {"min": float(np.nanmin(values)),
                "max": float(np.nanmax(values))}

    summary = {
        "evaluation_date": datetime.now().isoformat(),
        "total_models_evaluated": len(names),
        "best_performers": {
            "highest_auc": best("roc_auc", np.nanargmax),
            "lowest_eer": best("eer", np.nanargmin),
            "highest_accuracy": best("t0.5_accuracy", np.nanargmax),
        },
        "performance_ranges": {
            "auc": span("roc_auc"),
            "eer": span("eer"),
            "accuracy": span("t0.5_accuracy"),
        },
    }
    with open(results / "final_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary
