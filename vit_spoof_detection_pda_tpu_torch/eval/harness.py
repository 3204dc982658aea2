"""Cross-model evaluation harness and comparison reports (counterpart of
the JAX package's ``eval/harness.py``).

Reference contract (testing_set_analysis_src/evaluate_all_models.py):

- per model directory under `output_dir/<ModelName>/`:
  per_image_predictions.csv (image_path, true_label, spoof_score,
  predicted_label_0.5), roc_curve_data.csv (fpr, tpr, threshold),
  threshold_analysis.csv (0.1..0.9 + EER threshold rows),
  confusion_matrices.json (tau=0.5 / 0.7 / EER), evaluation_summary.json,
  evaluation_report.txt            (save_model_results, :179-279)
- cross-model: model_comparison.{csv,json}, comparison_report.txt
  (create_comparison_reports, :358-434)

The CSVs are written without pandas (``eval/single.py::write_csv``),
byte-equal to the JAX writer's.  Convention: harness labels are 1 =
spoof, scores are P(spoof) (:38-42, :145), converted from the canonical
1 = live (``data/conventions.py``).  Each model evaluates inside its own
try/except so one failure does not end the sweep (:472-502); a caller
that must not miss a model checks the returned names.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.conventions import harness_labels, harness_scores
from ..data.manifest import Record
from ..metrics import parity
from ..models.registry import MODEL_REGISTRY, build_model
from .runner import run_inference
from .single import records_frame, write_csv

log = logging.getLogger(__name__)

# reference defaults (evaluate_all_models.py:38, :243)
THRESHOLDS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
CM_THRESHOLDS = (0.5, 0.7)


def evaluate_scores(y_true_spoof, spoof_scores, *,
                    thresholds: Optional[Sequence[float]] = None) -> Dict:
    """All harness metrics from (1=spoof labels, P(spoof) scores)."""
    thresholds = list(thresholds) if thresholds is not None else THRESHOLDS
    fpr, tpr, thr = parity.np_roc_curve(y_true_spoof, spoof_scores)
    roc_auc = parity.np_auc_trapezoid(fpr, tpr)
    eer, eer_threshold = parity.find_eer_threshold(y_true_spoof, spoof_scores)
    threshold_rows = [
        parity.calculate_metrics_at_threshold(y_true_spoof, spoof_scores, t)
        for t in thresholds + [eer_threshold]]
    return {
        "roc": (fpr, tpr, thr),
        "roc_auc": roc_auc,
        "eer": eer,
        "eer_threshold": eer_threshold,
        "threshold_rows": threshold_rows,
    }


def run_cross_model_eval(records: Sequence[Record], *, output_dir: str,
                         checkpoint_path: Optional[str] = None,
                         pretrained_paths: Optional[dict] = None,
                         model_names: Optional[Sequence[str]] = None,
                         batch_size: int = 32, img_size: int = 224,
                         write_reports: bool = True,
                         fastserve: bool = False,
                         ema: bool = False,
                         thresholds: Optional[Sequence[float]] = None,
                         cm_thresholds: Optional[Sequence[float]] = None,
                         device=None) -> Dict[str, dict]:
    """Evaluate every registry model (f32) on ``records``; returns
    ``{model_name: summary_dict}`` (JAX :64).  ``fastserve=True`` scores
    the two ViTs (``ViTAntiSpoof``, ``ViTLinearHead``) on the serving path
    (bf16, ``eval/runner.py``); the ResNets keep the module path.  ``ema=True`` scores the EMA
    shadow of the checkpoint-loading entries (``checkpoint_path`` a
    training run's directory); the other entries are unaffected.  Models
    run on ``device`` (the card unless ``"cpu"``)."""
    from ..models.vit import ViTAntiSpoof, ViTLinearHead

    outp = Path(output_dir)
    outp.mkdir(parents=True, exist_ok=True)
    pretrained_paths = pretrained_paths or {}
    results = {}

    for name in (model_names or list(MODEL_REGISTRY)):
        try:
            log.info("evaluating %s ...", name)
            module = build_model(
                name, checkpoint_path=checkpoint_path,
                pretrained_path=pretrained_paths.get(name),
                ema=ema and MODEL_REGISTRY[name].weights == "checkpoint",
                img_size=img_size, device=device)
            out = run_inference(
                module, records, batch_size=batch_size, img_size=img_size,
                fastserve=fastserve and isinstance(
                    module, (ViTAntiSpoof, ViTLinearHead)))
            y_spoof = harness_labels(out["labels"])
            spoof_scores = harness_scores(out["prob1"]).astype(np.float64)
            ev = evaluate_scores(y_spoof, spoof_scores,
                                 thresholds=thresholds)
            results[name] = save_model_results(
                name, records, y_spoof, spoof_scores, ev, outp,
                cm_thresholds=cm_thresholds)
            del module
        except Exception as e:                   # noqa: BLE001
            log.exception("model %s failed: %s — continuing", name, e)

    if write_reports and results:
        create_comparison_reports(results, outp, n_samples=len(records))
    return results


# --------------------------------------------------------------------------
# per-model artifacts
# --------------------------------------------------------------------------


def save_model_results(name, records, y_spoof, spoof_scores, ev,
                       output_dir: Path,
                       cm_thresholds: Optional[Sequence[float]] = None,
                       ) -> dict:
    cm_thresholds = tuple(cm_thresholds) if cm_thresholds is not None \
        else CM_THRESHOLDS

    mdir = output_dir / name
    mdir.mkdir(parents=True, exist_ok=True)

    # the label column derives from the SAME float32 values the CSV
    # stores: a float64 0.49999999 casts to exactly 0.5 in float32, and
    # a label computed pre-cast would disagree with what downstream
    # consumers re-derive from the file
    scores_f32 = spoof_scores.astype(np.float32)
    write_csv(mdir / "per_image_predictions.csv", {
        "image_path": [r.path for r in records],
        "true_label": y_spoof,
        "spoof_score": scores_f32,
        "predicted_label_0.5": (scores_f32 >= 0.5).astype(int),
    })

    fpr, tpr, thr = ev["roc"]
    write_csv(mdir / "roc_curve_data.csv",
              {"fpr": fpr, "tpr": tpr, "threshold": thr})

    # the reference sorts by threshold, interleaving the EER row
    # (evaluate_all_models.py:202) — golden artifacts pin the order;
    # numpy's quicksort is pandas' sort_values
    rows = ev["threshold_rows"]
    order = np.argsort(np.asarray([r["threshold"] for r in rows]),
                       kind="quicksort")
    write_csv(mdir / "threshold_analysis.csv",
              records_frame([rows[i] for i in order]))

    by_t = {r["threshold"]: r for r in rows}

    def _row_at(t):
        # rows for grid members were already computed in evaluate_scores
        row = by_t.get(t)
        if row is None:
            row = parity.calculate_metrics_at_threshold(
                y_spoof, spoof_scores, t)
            by_t[t] = row
        return row

    cms = {}
    for t in (*cm_thresholds, ev["eer_threshold"]):
        row = _row_at(t)
        cms[f"threshold_{t:.3f}"] = {
            "confusion_matrix": [[row["tn"], row["fp"]],
                                 [row["fn"], row["tp"]]],
            "threshold": float(t),
        }
    with open(mdir / "confusion_matrices.json", "w") as f:
        json.dump(cms, f, indent=2)

    n_live = int(np.sum(y_spoof == 0))
    n_spoof = int(np.sum(y_spoof == 1))
    summary = {
        "model_name": name,
        "evaluation_timestamp": datetime.now().isoformat(),
        "total_samples": len(records),
        "live_samples": n_live,
        "spoof_samples": n_spoof,
        "roc_auc": float(ev["roc_auc"]),
        "eer": float(ev["eer"]),
        "eer_threshold": float(ev["eer_threshold"]),
        "score_statistics": {
            "mean": float(np.mean(spoof_scores)),
            "std": float(np.std(spoof_scores)),
            "min": float(np.min(spoof_scores)),
            "max": float(np.max(spoof_scores)),
        },
        "operating_points": {
            "threshold_0.5": _row_at(0.5),
            "threshold_0.7": _row_at(0.7),
            "eer_point": _row_at(ev["eer_threshold"]),
        },
    }
    with open(mdir / "evaluation_summary.json", "w") as f:
        json.dump(summary, f, indent=2)

    _write_report_txt(mdir / "evaluation_report.txt", summary)
    return summary


def _write_report_txt(path: Path, s: dict):
    bar = "=" * 60
    sub = "-" * 60
    with open(path, "w") as f:
        f.write(f"{bar}\nFACE ANTI-SPOOFING EVALUATION REPORT\n{bar}\n\n")
        f.write(f"Model: {s['model_name']}\n")
        f.write(f"Evaluation Date: "
                f"{s['evaluation_timestamp'][:19].replace('T', ' ')}\n\n")
        f.write(f"DATASET INFO\n{sub}\n")
        f.write(f"Total Samples:   {s['total_samples']}\n")
        f.write(f"Live Samples:    {s['live_samples']}\n")
        f.write(f"Spoof Samples:   {s['spoof_samples']}\n\n")
        f.write(f"OVERALL PERFORMANCE\n{sub}\n")
        f.write(f"ROC AUC:         {s['roc_auc']:.4f}\n")
        f.write(f"EER:             {s['eer']:.4f} ({s['eer'] * 100:.2f}%)\n")
        f.write(f"EER Threshold:   {s['eer_threshold']:.4f}\n\n")
        # exact reference layout (evaluate_all_models.py:261-277): plain
        # 'Threshold: {t:.4f}' headings and the two-line CM
        f.write(f"METRICS AT KEY THRESHOLDS\n{sub}\n\n")
        for key in ("threshold_0.5", "threshold_0.7", "eer_point"):
            m = s["operating_points"][key]
            f.write(f"Threshold: {m['threshold']:.4f}\n")
            f.write(f"  Accuracy:        {m['accuracy']:.4f} "
                    f"({m['accuracy'] * 100:.2f}%)\n")
            f.write(f"  F1-Score:        {m['f1_score']:.4f}\n")
            f.write(f"  Precision:       {m['precision']:.4f}\n")
            f.write(f"  Recall:          {m['recall']:.4f}\n")
            f.write(f"  APCER (FAR):     {m['apcer']:.4f} "
                    f"({m['apcer'] * 100:.2f}%)\n")
            f.write(f"  BPCER (FRR):     {m['bpcer']:.4f} "
                    f"({m['bpcer'] * 100:.2f}%)\n")
            f.write(f"  Confusion Matrix:\n")
            f.write(f"    TN: {m['tn']}, FP: {m['fp']}\n")
            f.write(f"    FN: {m['fn']}, TP: {m['tp']}\n\n")


# --------------------------------------------------------------------------
# comparison reports
# --------------------------------------------------------------------------


def create_comparison_reports(results: Dict[str, dict], output_dir: Path,
                              n_samples: int) -> list:
    """model_comparison.{csv,json} and comparison_report.txt (JAX :260);
    returns the comparison rows in roc_auc-descending order."""
    rows = []
    for name, s in results.items():
        eer_m = s["operating_points"]["eer_point"]
        t5 = s["operating_points"]["threshold_0.5"]
        t7 = s["operating_points"]["threshold_0.7"]
        rows.append({
            "model_name": name,
            "roc_auc": s["roc_auc"],
            "eer": s["eer"],
            "eer_threshold": s["eer_threshold"],
            "eer_accuracy": eer_m["accuracy"],
            "eer_apcer": eer_m["apcer"],
            "eer_bpcer": eer_m["bpcer"],
            "eer_f1": eer_m["f1_score"],
            "t0.5_accuracy": t5["accuracy"],
            "t0.5_apcer": t5["apcer"],
            "t0.5_bpcer": t5["bpcer"],
            "t0.5_f1": t5["f1_score"],
            "t0.7_accuracy": t7["accuracy"],
            "t0.7_apcer": t7["apcer"],
            "t0.7_bpcer": t7["bpcer"],
            "t0.7_f1": t7["f1_score"],
        })
    # reference contract (evaluate_all_models.py:385-434): the CSV and
    # every report table iterate the roc_auc-DESCENDING order; the JSON
    # comparison_table keeps insertion order and the best_model_by_*
    # keys come from the sorted frame
    ranked = sorted(rows, key=lambda r: -r["roc_auc"])
    write_csv(output_dir / "model_comparison.csv", records_frame(ranked))
    with open(output_dir / "model_comparison.json", "w") as f:
        json.dump({
            "comparison_timestamp": datetime.now().isoformat(),
            "models_evaluated": list(results),
            "comparison_table": rows,
            "best_model_by_auc": ranked[0]["model_name"],
            # ties resolve within the AUC-sorted frame, like the
            # reference's idxmin/idxmax on the sorted comparison_df
            "best_model_by_eer": min(
                ranked, key=lambda r: r["eer"])["model_name"],
            "best_model_by_accuracy": max(
                ranked, key=lambda r: r["t0.5_accuracy"])["model_name"],
        }, f, indent=2)

    bar = "=" * 80
    sub = "-" * 80
    with open(output_dir / "comparison_report.txt", "w") as f:
        f.write(f"{bar}\nMODEL COMPARISON REPORT\n{bar}\n\n")
        f.write(f"Evaluation Date: "
                f"{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.write("Test Dataset: test_inf/\n")
        f.write(f"Total Samples: {n_samples}\n\n")
        f.write(f"RANKING BY ROC AUC\n{sub}\n")
        for i, r in enumerate(ranked, 1):
            f.write(f"{i}. {r['model_name']:40s} "
                    f"AUC: {r['roc_auc']:.4f}\n")
        f.write(f"\n\nDETAILED COMPARISON AT THRESHOLD = 0.5\n{sub}\n")
        f.write(f"{'Model':<40s} {'Accuracy':<12s} {'APCER':<12s} "
                f"{'BPCER':<12s} {'F1':<12s}\n{sub}\n")
        for r in ranked:
            f.write(f"{r['model_name']:<40s} {r['t0.5_accuracy']:<12.4f} "
                    f"{r['t0.5_apcer']:<12.4f} {r['t0.5_bpcer']:<12.4f} "
                    f"{r['t0.5_f1']:<12.4f}\n")
        f.write(f"\n\nDETAILED COMPARISON AT EER POINT\n{sub}\n")
        f.write(f"{'Model':<40s} {'EER':<12s} {'Threshold':<12s} "
                f"{'Accuracy':<12s} {'F1':<12s}\n{sub}\n")
        for r in ranked:
            f.write(f"{r['model_name']:<40s} {r['eer']:<12.4f} "
                    f"{r['eer_threshold']:<12.4f} {r['eer_accuracy']:<12.4f} "
                    f"{r['eer_f1']:<12.4f}\n")
    return ranked
