"""Single-model evaluation with the test.py artifact contract
(counterpart of the JAX package's ``eval/single.py``).

Artifacts (reference test.py:319-451), timestamped into ``output_dir``:
test_metrics_*.csv, per_image_results_*.csv, confusion_matrix_*.{csv,png},
roc_curve_*.png, per_subject_results_*.csv, test_summary_*.txt, with the
JAX package's file names, columns, row order and text.

The JAX writer builds its CSVs with pandas, which the card's machine
lacks; :func:`write_csv` writes them with the stdlib ``csv`` module,
formatting each column as pandas ``to_csv`` does (:func:`column_strings`),
so the files are byte-equal.  Plots need matplotlib: where it does not
import, one warning is logged and the ``*_png`` keys are absent, as when
the JAX writer's plots fail.

Convention: canonical 1 = live, scores are P(live) (test.py:117, 217).
"""

from __future__ import annotations

import csv
import logging
from datetime import datetime
from pathlib import Path
from typing import Sequence

import numpy as np

from ..data.manifest import Record
from ..metrics import parity
from .runner import run_inference

log = logging.getLogger(__name__)


def column_strings(values) -> list:
    """One column's fields as pandas ``to_csv`` writes them (no
    ``float_format``): a float column through numpy's ``astype(str)``
    (float32 with float32's shortest repr, float64 with Python's), NaN
    as an empty field; bools as True/False; ints and strings as
    ``str``.  A list mixing ints and floats is a float column, as in
    pandas."""
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        out = arr.astype(str).astype(object)
        out[np.isnan(arr)] = ""
        return out.tolist()
    return [str(v) for v in arr.tolist()]


def write_csv(path, columns: dict, *, index=None, index_label: str = ""):
    """Write ``{name: column}`` as pandas ``DataFrame(columns).to_csv(path,
    index=...)`` would: a header row, one row per element, ``\\n`` line
    ends, minimal quoting; ``index`` (a column of labels) goes first under
    ``index_label``."""
    names = list(columns)
    cols = [column_strings(v) for v in columns.values()]
    if index is not None:
        names = [index_label] + names
        cols = [column_strings(index)] + cols
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*cols))


def records_frame(rows: Sequence[dict]) -> dict:
    """``pd.DataFrame(rows)``'s columns from a list of dicts with the same
    keys."""
    return {k: [r[k] for r in rows] for k in rows[0]}


def run_single_model_eval(module, records: Sequence[Record], *,
                          output_dir: str, batch_size: int = 128,
                          img_size: int = 224, threshold: float = 0.5,
                          checkpoint_name: str = "",
                          write_plots: bool = True, mesh=None,
                          fastserve: bool = False):
    """Score ``records`` with ``module`` and write the artifact set (JAX
    :29); returns ``(metrics, paths)``.  ``fastserve=True`` scores on the
    serving path (opt-in bf16 throughput mode, ``eval/runner.py``).
    ``mesh``: data-parallel scoring (``run_inference``); every rank gets
    the metrics, rank 0 alone writes the files (``paths`` is empty
    elsewhere)."""
    from ..parallel.mesh import is_primary

    out = run_inference(module, records, batch_size=batch_size,
                        img_size=img_size, fastserve=fastserve, mesh=mesh)
    y_true = out["labels"]
    y_prob = out["prob1"]           # P(live)
    # decisions at the requested operating point (reference test.py uses
    # 0.5; out["pred"] is the same 0.5 cut, reused when default)
    y_pred = (out["pred"] if threshold == 0.5 else
              (np.asarray(y_prob) > threshold).astype(np.int32))
    metrics, cm = parity.calculate_metrics(y_true, y_pred, y_prob)
    paths = {}
    if is_primary():
        paths = _save_results(metrics, cm, y_true, y_pred, y_prob, records,
                              Path(output_dir), checkpoint_name, write_plots)
    return metrics, paths


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (logged) where
    matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        log.warning("matplotlib is not installed: the confusion-matrix and "
                    "ROC plots are not written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save_plots(plt, cm, y_true, y_prob, metrics, output_dir, ts, paths):
    try:
        import seaborn as sns
        plt.figure(figsize=(10, 8))
        sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                    xticklabels=["Spoof", "Live"],
                    yticklabels=["Spoof", "Live"])
        plt.title("Confusion Matrix", fontsize=16, fontweight="bold")
        plt.ylabel("True Label")
        plt.xlabel("Predicted Label")
        plt.tight_layout()
        paths["cm_png"] = output_dir / f"confusion_matrix_{ts}.png"
        plt.savefig(paths["cm_png"], dpi=300, bbox_inches="tight")
        plt.close()
    except Exception as e:                   # noqa: BLE001
        log.warning("confusion-matrix plot failed: %s", e)

    try:
        fpr, tpr, _ = parity.np_roc_curve(y_true, y_prob)
        plt.figure(figsize=(10, 8))
        plt.plot(fpr, tpr, color="darkorange", lw=2,
                 label=f"ROC curve (AUC = {metrics['auc']:.4f})")
        plt.plot([0, 1], [0, 1], color="navy", lw=2, linestyle="--",
                 label="Random")
        plt.xlim([0.0, 1.0])                # reference test.py:384-385
        plt.ylim([0.0, 1.05])
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.title("ROC Curve", fontsize=16, fontweight="bold")
        plt.legend(loc="lower right")
        plt.grid(alpha=0.3)
        plt.tight_layout()
        paths["roc_png"] = output_dir / f"roc_curve_{ts}.png"
        plt.savefig(paths["roc_png"], dpi=300, bbox_inches="tight")
        plt.close()
    except Exception as e:                   # noqa: BLE001
        log.warning("ROC plot failed: %s", e)


def _per_subject(subjects: list, correct: np.ndarray) -> dict:
    """The JAX writer's ``groupby("subject_id").agg(sum, count, mean)
    .round(4).sort_values("accuracy")``: groups in sorted key order, then
    numpy's quicksort on the rounded accuracy (pandas' own sort)."""
    keys = sorted(set(subjects))
    pos = {k: i for i, k in enumerate(keys)}
    which = np.array([pos[s] for s in subjects], np.int64)
    hits = np.bincount(which, weights=correct, minlength=len(keys))
    total = np.bincount(which, minlength=len(keys))
    acc = np.round(hits / total, 4)
    order = np.argsort(acc, kind="quicksort")
    return {"index": [keys[i] for i in order],
            "correct_predictions": hits.astype(np.int64)[order],
            "total_images": total[order], "accuracy": acc[order]}


def _save_results(metrics, cm, y_true, y_pred, y_prob, records, output_dir,
                  checkpoint_name, write_plots):
    output_dir.mkdir(parents=True, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    paths = {}

    paths["metrics"] = output_dir / f"test_metrics_{ts}.csv"
    write_csv(paths["metrics"], {k: [v] for k, v in metrics.items()})

    correct = y_true == y_pred
    subjects = [r.subject or "" for r in records]
    paths["per_image"] = output_dir / f"per_image_results_{ts}.csv"
    write_csv(paths["per_image"], {
        "image_path": [r.path for r in records],
        "image_name": [r.name or Path(r.path).name for r in records],
        "subject_id": subjects,
        "true_label": np.where(y_true == 1, "live", "spoof"),
        "predicted_label": np.where(y_pred == 1, "live", "spoof"),
        "probability_live": y_prob,
        "probability_spoof": 1.0 - y_prob,
        "correct": correct,
    })

    # confusion matrix CSV (reference axis order: [spoof, live], its cm
    # comes from labels sorted ascending with 0=spoof)
    paths["cm_csv"] = output_dir / f"confusion_matrix_{ts}.csv"
    write_csv(paths["cm_csv"], {"Predicted Spoof": cm[:, 0],
                                "Predicted Live": cm[:, 1]},
              index=["Actual Spoof", "Actual Live"])

    plt = _pyplot() if write_plots else None
    if plt is not None:
        _save_plots(plt, cm, y_true, y_prob, metrics, output_dir, ts, paths)

    subject = _per_subject(subjects, correct)
    paths["per_subject"] = output_dir / f"per_subject_results_{ts}.csv"
    write_csv(paths["per_subject"],
              {k: v for k, v in subject.items() if k != "index"},
              index=subject["index"], index_label="subject_id")

    paths["summary"] = output_dir / f"test_summary_{ts}.txt"
    with open(paths["summary"], "w") as f:
        bar = "=" * 60
        sub = "-" * 60
        f.write(f"{bar}\nFACE ANTI-SPOOFING TEST REPORT\n{bar}\n\n")
        f.write(f"Checkpoint: {checkpoint_name}\n\n")
        f.write(f"OVERALL PERFORMANCE\n{sub}\n")
        f.write(f"Accuracy:        {metrics['accuracy']:.4f} "
                f"({metrics['accuracy'] * 100:.2f}%)\n")
        f.write(f"AUC-ROC:         {metrics['auc']:.4f}\n")
        f.write(f"F1-Score:        {metrics['f1_score']:.4f}\n\n")
        f.write(f"DETECTION METRICS\n{sub}\n")
        f.write(f"Precision (PPV): {metrics['precision']:.4f}\n")
        f.write(f"Recall (TPR):    {metrics['recall']:.4f}\n")
        f.write(f"Specificity:     {metrics['specificity']:.4f}\n")
        f.write(f"NPV:             {metrics['npv']:.4f}\n\n")
        f.write(f"ERROR RATES\n{sub}\n")
        f.write(f"FAR (FPR):       {metrics['far']:.4f} "
                f"({metrics['far'] * 100:.2f}%)\n")
        f.write(f"FRR (FNR):       {metrics['frr']:.4f} "
                f"({metrics['frr'] * 100:.2f}%)\n")
        f.write(f"EER:             {metrics['eer']:.4f} "
                f"({metrics['eer'] * 100:.2f}%)\n\n")
        f.write(f"CONFUSION MATRIX\n{sub}\n")
        f.write(f"True Negatives:  {metrics['tn']}\n")
        f.write(f"False Positives: {metrics['fp']}\n")
        f.write(f"False Negatives: {metrics['fn']}\n")
        f.write(f"True Positives:  {metrics['tp']}\n\n")
        f.write(f"DATASET INFO\n{sub}\n")
        f.write(f"Total Samples:   {metrics['total_samples']}\n")
        f.write(f"Live Samples:    {metrics['live_samples']}\n")
        f.write(f"Spoof Samples:   {metrics['spoof_samples']}\n")
    return paths
