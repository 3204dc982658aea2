"""Analysis and reporting (the port's counterpart of the JAX package's
``analysis/``), over the results directory the eval verbs write, with the
reference's file contracts and without pandas (the card's machine has
none): the CSVs are byte-equal to the JAX package's.

`distributions.py`  — score-distribution stats + Cohen's d / overlap.
`failed_cases.py`   — top-N false-positive / false-negative miner.
`latency.py`        — single-image latency protocol + batched throughput.
`summary.py`        — final_summary.json generator.
`figures.py`        — publication-figure suite (matplotlib, when called).
`attention_maps.py` — attention-rollout saliency, the rollout on the card.
`calibration.py`    — reliability curves, ECE/MCE/Brier/NLL, temperature
scaling.
`xprof.py`          — device-time tables from a torch.profiler trace.
`tables.py`         — the pandas-typed CSV reader and the plot switch.
"""

from .attention_maps import (attention_rollout, cls_patch_relevance,
                             generate_attention_overlays)
from .calibration import (analyze_calibration, apply_temperature,
                          calibration_errors, fit_temperature,
                          plot_reliability_diagram, reliability_curve)
from .distributions import analyze_score_distributions
from .failed_cases import extract_failed_cases
from .latency import benchmark_models, benchmark_single_image
from .summary import generate_summary_statistics

__all__ = [
    "analyze_score_distributions", "extract_failed_cases",
    "attention_rollout", "cls_patch_relevance",
    "generate_attention_overlays",
    "analyze_calibration", "apply_temperature", "calibration_errors",
    "fit_temperature", "plot_reliability_diagram", "reliability_curve",
    "benchmark_models", "benchmark_single_image",
    "generate_summary_statistics",
]
