"""Publication-figure suite (the port's copy of the JAX package's
``analysis/figures.py``, without pandas; matplotlib is imported when a
generator runs, not with the module).

The reference's data_vis generators over the results-directory file
contracts (per_image_predictions.csv, roc_curve_data.csv,
threshold_analysis.csv, score_distributions.csv, model_comparison.csv),
with the JAX package's file names:

- augmentation grid            (generate_figures.py Fig2 + 2x2 variant;
  the port's ``augment/policy.py`` heavy tier on the CPU)
- ROC comparison               (Fig4)
- APCER/BPCER trade-off + EER  (Fig5/6: the combined overlay, and
  :func:`figure_apcer_bpcer_reference`, the per-model replica with the
  reference's frr-as-APCER column read, generate_figures.py:158-161)
- score histograms             (Fig7/8)
- confusion matrices at EER    (Fig9/10)
- misclassified grids          (Fig11/12 + 2x2, with exclusion lists; PIL)
- fine-tuning impact bars      (generate_additional_figures.py FigA)
- threshold table PNG          (FigB, red highlight > 85%)
- violin plots                 (FigC + violin_plot.py re-render)
- overlaid histograms + Cohen's d warnings (FigD)

Every figure renders with the Agg backend; each generator is independent
and failure-isolated in :func:`generate_all_figures`.
"""

from __future__ import annotations

import functools
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from .tables import read_csv

log = logging.getLogger(__name__)

MODEL_COLORS = {
    "Custom_ViT_FineTuned": "#1f77b4",
    "Base_ViT_Pretrained": "#ff7f0e",
    "ResNet50_Pretrained": "#2ca02c",
    "SigNet_F": "#d62728",
}

# the reference's publication rcParams (generate_figures.py:36-44)
PUBLICATION_RC = {
    "figure.dpi": 300,
    "savefig.dpi": 300,
    "font.family": "serif",
    "font.size": 10,
    "axes.labelsize": 11,
    "axes.titlesize": 12,
    "xtick.labelsize": 9,
    "ytick.labelsize": 9,
    "legend.fontsize": 9,
}

# the reference's publication-safety exclusion lists, per model and error
# type (generate_figures.py:14-32)
EXCLUDED_IMAGES = {
    "Custom_ViT_FineTuned": {
        "false_positives": {"FP_score0.8125_513034.png"},
        "false_negatives": set(),
    },
    "ResNet50_Pretrained": {
        "false_positives": {"FP_score0.6770_500049.png",
                            "FP_score0.6781_548494.png"},
        "false_negatives": set(),
    },
}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _published(fn):
    """Render a generator under the reference's publication rcParams."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _plt().rc_context(PUBLICATION_RC):
            return fn(*args, **kwargs)
    return wrapper


def _load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _model_dirs(results_dir: Path):
    return sorted(p for p in results_dir.iterdir()
                  if p.is_dir() and p.name != "failed_cases_analysis")


def _save(fig, out: Path, name: str, dpi: int = 300):
    out.mkdir(parents=True, exist_ok=True)
    path = out / name
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _plt().close(fig)
    log.info("wrote %s", path)
    return path


def _grid_axes(n: int, w: float, h: float):
    plt = _plt()
    cols = min(2, n)
    rows = (n + cols - 1) // cols
    return plt.subplots(rows, cols, figsize=(w * cols, h * rows),
                        squeeze=False)


# --------------------------------------------------------------------------


@_published
def figure_augmentation_grid(sample_image: np.ndarray, output_dir: str, *,
                             grid: str = "2x4", seed: int = 0):
    """Original + augmented variants of one float [H, W, 3] image in
    [0, 1] (Fig2 / the 2x2 variant), drawn by the heavy tier on the CPU."""
    import torch

    from ..augment.policy import make_batch_augmenter

    plt = _plt()
    rows, cols = (2, 4) if grid == "2x4" else (2, 2)
    n = rows * cols
    aug = make_batch_augmenter("heavy")
    batch = torch.from_numpy(
        np.stack([sample_image.astype(np.float32)] * (n - 1)))
    outs = aug(torch.Generator().manual_seed(seed), batch).numpy()

    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    images = [sample_image] + list(outs)
    titles = ["Original"] + [f"Augmented {i + 1}" for i in range(n - 1)]
    for ax, im, t in zip(axes.ravel(), images, titles):
        ax.imshow(np.clip(im, 0, 1))
        ax.set_title(t, fontsize=10)
        ax.axis("off")
    fig.suptitle("Differential Data Augmentation", fontweight="bold")
    return _save(fig, Path(output_dir), f"figure_augmentation_{grid}.png")


@_published
def figure_roc_comparison(results_dir: str, output_dir: str):
    """Overlaid ROC curves from each model's roc_curve_data.csv (Fig4)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 7))
    for mdir in _model_dirs(Path(results_dir)):
        f = mdir / "roc_curve_data.csv"
        if not f.exists():
            continue
        df = read_csv(f)
        summary = _load_json(mdir / "evaluation_summary.json")
        ax.plot(df["fpr"], df["tpr"], lw=2,
                color=MODEL_COLORS.get(mdir.name),
                label=f"{mdir.name} (AUC = {summary['roc_auc']:.4f})")
    ax.plot([0, 1], [0, 1], "k--", lw=1, label="Random")
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title("ROC Curve Comparison", fontweight="bold")
    ax.legend(loc="lower right", fontsize=9)
    ax.grid(alpha=0.3)
    return _save(fig, Path(output_dir), "figure_roc_comparison.png")


@_published
def figure_apcer_bpcer_tradeoff(results_dir: str, output_dir: str):
    """APCER vs BPCER over the threshold grid with the EER point starred
    (Fig5/6)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 7))
    for mdir in _model_dirs(Path(results_dir)):
        f = mdir / "threshold_analysis.csv"
        if not f.exists():
            continue
        df = read_csv(f)
        order = np.argsort(df["threshold"], kind="stable")
        color = MODEL_COLORS.get(mdir.name)
        ax.plot(df["apcer"][order], df["bpcer"][order], "o-", lw=1.5, ms=4,
                color=color, label=mdir.name)
        summary = _load_json(mdir / "evaluation_summary.json")
        ax.plot([summary["eer"]],
                [summary["operating_points"]["eer_point"]["bpcer"]],
                "*", ms=16, color=color)
    ax.plot([0, 1], [0, 1], "k:", lw=1, alpha=0.5)
    ax.set_xlabel("APCER (Attack Presentation Classification Error Rate)")
    ax.set_ylabel("BPCER (Bona-fide Presentation Classification Error Rate)")
    ax.set_title("APCER / BPCER Trade-off (stars = EER points)",
                 fontweight="bold")
    ax.legend(fontsize=9)
    ax.grid(alpha=0.3)
    return _save(fig, Path(output_dir), "figure_apcer_bpcer_tradeoff.png")


# the reference's Fig5/6 styling: (color, marker, title) per model
# (generate_figures.py:167-168, 208-209, 181-183, 222-224)
_QUIRK_STYLE = {
    "Custom_ViT_FineTuned": ("#2E86AB", "o", "Custom ViT"),
    "ResNet50_Pretrained": ("#A23B72", "s", "ResNet-50"),
}


@_published
def figure_apcer_bpcer_reference(results_dir: str, output_dir: str, *,
                                 model: str = "Custom_ViT_FineTuned"):
    """The reference's per-model Fig5/6 with its column read: the ``frr``
    column plotted as APCER and ``far`` as BPCER (generate_figures.py:
    158-161), single model, equal aspect, red EER star."""
    f = Path(results_dir) / model / "threshold_analysis.csv"
    sjson = Path(results_dir) / model / "evaluation_summary.json"
    if not f.exists() or not sjson.exists():
        return None
    plt = _plt()
    df = read_csv(f)
    apcer, bpcer = df["frr"], df["far"]            # the reference's read
    color, marker, title = _QUIRK_STYLE.get(
        model, ("#2E86AB", "o", model.replace("_", " ")))
    summary = _load_json(sjson)
    eer, eer_t = summary["eer"], summary["eer_threshold"]

    fig, ax = plt.subplots(figsize=(7, 6))
    ax.plot(apcer, bpcer, linewidth=2.5, color=color, marker=marker,
            markersize=4, markevery=1)
    eer_idx = int(np.argmin(np.abs(df["threshold"] - eer_t)))
    ax.scatter([apcer[eer_idx]], [bpcer[eer_idx]], color="red",
               s=150, marker="*", zorder=5,
               label=f"EER={eer:.4f} (t={eer_t:.4f})")
    ax.plot([0, 1], [0, 1], "k--", linewidth=1, alpha=0.5)
    ax.set_xlabel("APCER (Attack Accepted as Genuine)", fontsize=11)
    ax.set_ylabel("BPCER (Genuine Rejected as Attack)", fontsize=11)
    ax.set_title(f"{title}: APCER vs BPCER Trade-off", fontsize=12,
                 fontweight="bold")
    ax.legend(loc="upper right", frameon=True, fancybox=True, shadow=True)
    ax.grid(True, alpha=0.3, linestyle="--")
    ax.set_xlim([0, 1])
    ax.set_ylim([0, 1])
    ax.set_aspect("equal")
    return _save(fig, Path(output_dir), f"apcer_bpcer_{model}.png")


def _by_label(df: dict, label: str) -> np.ndarray:
    return df["score"][df["label"] == label]


@_published
def figure_score_histograms(results_dir: str, output_dir: str):
    """Per-model live/spoof score histograms (Fig7/8)."""
    dirs = [d for d in _model_dirs(Path(results_dir))
            if (d / "score_distributions.csv").exists()]
    if not dirs:
        return None
    fig, axes = _grid_axes(len(dirs), 7, 5)
    for ax, mdir in zip(axes.ravel(), dirs):
        df = read_csv(mdir / "score_distributions.csv")
        for label, color in (("live", "#2ca02c"), ("spoof", "#d62728")):
            ax.hist(_by_label(df, label), bins=40, alpha=0.6,
                    color=color, label=label, density=True)
        ax.axvline(0.5, color="k", ls="--", lw=1)
        ax.set_title(mdir.name)
        ax.set_xlabel("Spoof score")
        ax.set_ylabel("Density")
        ax.legend()
    for ax in axes.ravel()[len(dirs):]:
        ax.axis("off")
    fig.suptitle("Score Distributions by Model", fontweight="bold")
    return _save(fig, Path(output_dir), "figure_score_histograms.png")


@_published
def figure_confusion_matrices(results_dir: str, output_dir: str,
                              threshold_key: str = "eer_point"):
    """Confusion matrices at the EER operating point (Fig9/10)."""
    dirs = [d for d in _model_dirs(Path(results_dir))
            if (d / "evaluation_summary.json").exists()]
    if not dirs:
        return None
    fig, axes = _grid_axes(len(dirs), 5, 4.5)
    for ax, mdir in zip(axes.ravel(), dirs):
        s = _load_json(mdir / "evaluation_summary.json")
        m = s["operating_points"][threshold_key]
        cm = np.array([[m["tn"], m["fp"]], [m["fn"], m["tp"]]])
        im = ax.imshow(cm, cmap="Blues")
        for (i, j), v in np.ndenumerate(cm):
            ax.text(j, i, str(v), ha="center", va="center",
                    color="white" if v > cm.max() / 2 else "black",
                    fontsize=14)
        ax.set_xticks([0, 1], ["Live", "Spoof"])
        ax.set_yticks([0, 1], ["Live", "Spoof"])
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Actual")
        ax.set_title(f"{mdir.name}\n(EER threshold "
                     f"{s['eer_threshold']:.3f})", fontsize=10)
        fig.colorbar(im, ax=ax, shrink=0.7)
    for ax in axes.ravel()[len(dirs):]:
        ax.axis("off")
    fig.suptitle("Confusion Matrices at EER", fontweight="bold")
    return _save(fig, Path(output_dir), "figure_confusion_matrices_eer.png")


@_published
def figure_misclassified_grid(results_dir: str, output_dir: str, *,
                              model: str = "Custom_ViT_FineTuned",
                              kind: str = "false_positives",
                              grid: str = "2x4",
                              exclude: Optional[Sequence[str]] = None):
    """Worst misclassified image grid (Fig11/12 + 2x2 variant) with an
    exclusion list; defaults to the reference's list for the model and
    kind (generate_figures.py:14-32).  Reads the images through PIL."""
    from PIL import Image

    if exclude is None:
        exclude = EXCLUDED_IMAGES.get(model, {}).get(kind, set())
    fdir = Path(results_dir) / "failed_cases_analysis" / model / kind
    if not fdir.is_dir():
        log.warning("no failed-case dir %s", fdir)
        return None
    rows, cols = (2, 4) if grid == "2x4" else (2, 2)
    files = [f for f in sorted(fdir.iterdir())
             if f.suffix.lower() in (".png", ".jpg", ".jpeg")
             and not any(e in f.name for e in exclude)][:rows * cols]
    if not files:
        return None
    fig, axes = _plt().subplots(rows, cols, figsize=(3 * cols, 3.2 * rows))
    for ax, f in zip(np.ravel(axes), files):
        ax.imshow(Image.open(f))
        score = f.name.split("score")[1].split("_")[0] \
            if "score" in f.name else "?"
        ax.set_title(f"score={score}", fontsize=9)
        ax.axis("off")
    for ax in np.ravel(axes)[len(files):]:
        ax.axis("off")
    label = "False Positives (live -> spoof)" \
        if kind == "false_positives" else "False Negatives (spoof -> live)"
    fig.suptitle(f"{model}: worst {label}", fontweight="bold")
    return _save(fig, Path(output_dir),
                 f"figure_misclassified_{kind}_{grid}.png")


@_published
def figure_finetuning_impact(results_dir: str, output_dir: str):
    """Fine-tuned vs frozen ViT AUC bars with the improvement annotated
    (FigA)."""
    df = read_csv(Path(results_dir) / "model_comparison.csv")
    vals, names = [], []
    for key, label in (("Base_ViT_Pretrained", "Frozen ViT"),
                       ("Custom_ViT_FineTuned", "Fine-tuned ViT")):
        hit = np.flatnonzero(df["model_name"] == key)
        if len(hit):
            vals.append(float(df["roc_auc"][hit[0]]))
            names.append(label)
    if len(vals) < 2:
        return None
    fig, ax = _plt().subplots(figsize=(6, 5))
    bars = ax.bar(names, vals, color=["#ff7f0e", "#1f77b4"])
    for b, v in zip(bars, vals):
        ax.text(b.get_x() + b.get_width() / 2, v + 0.01, f"{v:.4f}",
                ha="center", fontweight="bold")
    if vals[0] > 0:
        ax.annotate(f"+{(vals[1] - vals[0]) / vals[0] * 100:.1f}%",
                    xy=(1, vals[1]), xytext=(0.5, max(vals) * 1.1),
                    ha="center", fontsize=14, color="green",
                    fontweight="bold",
                    arrowprops=dict(arrowstyle="->", color="green"))
    ax.axhline(0.5, color="k", ls=":", lw=1, label="Random (0.5)")
    ax.set_ylabel("ROC AUC")
    ax.set_title("Impact of Fine-tuning on ROC AUC", fontweight="bold")
    ax.legend()
    return _save(fig, Path(output_dir), "figure_finetuning_impact.png")


@_published
def figure_threshold_table(results_dir: str, output_dir: str, *,
                           model: str = "Custom_ViT_FineTuned",
                           highlight_above: float = 0.85):
    """Threshold-analysis table rendered as a PNG, error rates above 85%
    red (FigB)."""
    f = Path(results_dir) / model / "threshold_analysis.csv"
    if not f.exists():
        return None
    df = read_csv(f)
    columns = ["threshold", "accuracy", "f1_score", "apcer", "bpcer"]
    show = np.stack([np.round(df[c].astype(np.float64), 4) for c in columns],
                    axis=1)
    fig, ax = _plt().subplots(figsize=(8, 0.4 * len(show) + 1.5))
    ax.axis("off")
    table = ax.table(cellText=show.astype(str),
                     colLabels=[c.upper() for c in columns],
                     loc="center", cellLoc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(9)
    for (r, c), cell in table.get_celld().items():
        if r == 0:
            cell.set_facecolor("#404040")
            cell.set_text_props(color="white", fontweight="bold")
        elif columns[c] in ("apcer", "bpcer") and \
                show[r - 1, c] > highlight_above:
            cell.set_facecolor("#ffcccc")
    ax.set_title(f"{model}: Metrics by Threshold", fontweight="bold")
    return _save(fig, Path(output_dir),
                 f"figure_threshold_table_{model}.png")


@_published
def figure_violin(results_dir: str, output_dir: str):
    """Violin plots of the score distributions (FigC / violin_plot.py),
    live beside spoof for each model: matplotlib's violins, the JAX
    package's rendering where seaborn is absent."""
    frames = {mdir.name: read_csv(mdir / "score_distributions.csv")
              for mdir in _model_dirs(Path(results_dir))
              if (mdir / "score_distributions.csv").exists()}
    if not frames:
        return None
    models = sorted(frames)
    fig, ax = _plt().subplots(figsize=(2.8 * len(models) + 2, 6))
    for i, m in enumerate(models):
        ax.violinplot([_by_label(frames[m], "live"),
                       _by_label(frames[m], "spoof")],
                      positions=[i - 0.15, i + 0.15], widths=0.25)
    ax.set_xticks(range(len(models)), models)
    ax.axhline(0.5, color="k", ls="--", lw=1)
    ax.set_title("Score Distributions (violin)", fontweight="bold")
    _plt().setp(ax.get_xticklabels(), rotation=15, ha="right")
    return _save(fig, Path(output_dir), "figure_violin.png")


@_published
def figure_overlaid_histograms(results_dir: str, output_dir: str):
    """Overlaid live/spoof histograms with Cohen's d, and a LOW-SEPARATION
    warning where |d| < 0.5 (FigD)."""
    results = Path(results_dir)
    dist_json = results / "score_distribution_analysis.json"
    stats = _load_json(dist_json) if dist_json.exists() else {}
    dirs = [d for d in _model_dirs(results)
            if (d / "score_distributions.csv").exists()]
    if not dirs:
        return None
    fig, axes = _grid_axes(len(dirs), 7, 4.5)
    for ax, mdir in zip(axes.ravel(), dirs):
        df = read_csv(mdir / "score_distributions.csv")
        for label, color in (("live", "#2ca02c"), ("spoof", "#d62728")):
            ax.hist(_by_label(df, label), bins=50, alpha=0.5, color=color,
                    label=label)
        d = (stats.get(mdir.name, {}).get("separation_metrics", {})
             .get("cohen_d"))
        title = mdir.name
        if d is not None:
            title += f"  (Cohen's d = {d:.3f})"
            if abs(d) < 0.5:
                ax.text(0.5, 0.92, "LOW SEPARATION", transform=ax.transAxes,
                        ha="center", color="red", fontweight="bold")
        ax.set_title(title, fontsize=10)
        ax.legend()
    for ax in axes.ravel()[len(dirs):]:
        ax.axis("off")
    fig.suptitle("Overlaid Score Histograms", fontweight="bold")
    return _save(fig, Path(output_dir), "figure_overlaid_histograms.png")


# --------------------------------------------------------------------------


def generate_all_figures(results_dir: str, output_dir: str, *,
                         sample_image: Optional[np.ndarray] = None) -> Dict:
    """Run every generator, each failure-isolated: ``{name: path, None
    (nothing to plot) or "ERROR: ..."}``."""
    gens = [
        ("roc_comparison", lambda: figure_roc_comparison(
            results_dir, output_dir)),
        ("apcer_bpcer", lambda: figure_apcer_bpcer_tradeoff(
            results_dir, output_dir)),
        ("apcer_bpcer_vit_ref", lambda: figure_apcer_bpcer_reference(
            results_dir, output_dir, model="Custom_ViT_FineTuned")),
        ("apcer_bpcer_resnet_ref", lambda: figure_apcer_bpcer_reference(
            results_dir, output_dir, model="ResNet50_Pretrained")),
        ("score_histograms", lambda: figure_score_histograms(
            results_dir, output_dir)),
        ("confusion_matrices", lambda: figure_confusion_matrices(
            results_dir, output_dir)),
        ("finetuning_impact", lambda: figure_finetuning_impact(
            results_dir, output_dir)),
        ("threshold_table", lambda: figure_threshold_table(
            results_dir, output_dir)),
        ("violin", lambda: figure_violin(results_dir, output_dir)),
        ("overlaid_histograms", lambda: figure_overlaid_histograms(
            results_dir, output_dir)),
        ("misclassified_fp", lambda: figure_misclassified_grid(
            results_dir, output_dir, kind="false_positives")),
        ("misclassified_fn", lambda: figure_misclassified_grid(
            results_dir, output_dir, kind="false_negatives")),
    ]
    if sample_image is not None:
        gens.insert(0, ("augmentation_grid", lambda: figure_augmentation_grid(
            sample_image, output_dir)))
        gens.insert(1, ("augmentation_2x2", lambda: figure_augmentation_grid(
            sample_image, output_dir, grid="2x2")))
    out = {}
    for name, fn in gens:
        try:
            out[name] = fn()
        except Exception as e:                       # noqa: BLE001
            log.exception("figure %s failed: %s", name, e)
            out[name] = f"ERROR: {e}"
    return out
