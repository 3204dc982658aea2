"""`analyze` command (JAX ``cli/analyze.py``): score distributions, failed
cases, summary, calibration, latency benchmark, attention overlays,
figures and trace tables over a results directory (reference
additional_analysis.py main + data_vis generators).

The file analyses run on the host and need no card.  ``--latency`` and
``--attention-overlays`` compute on the card unless ``--device cpu``.
The plots need matplotlib: where it does not import, one warning is
logged and their keys are absent from the result."""

from __future__ import annotations

import argparse

from ..analysis import (analyze_score_distributions, extract_failed_cases,
                        generate_summary_statistics)
from ..eval.single import pyplot
from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Post-evaluation analysis over a results directory")
    add_config_args(parser)
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--test-data-dir", default="")
    parser.add_argument("--figures", action="store_true",
                        help="also render the publication figure suite")
    parser.add_argument("--latency", action="store_true",
                        help="also run the latency benchmark protocol")
    parser.add_argument("--calibration", action="store_true",
                        help="also run the probability-calibration "
                        "report (reliability curves, ECE, temperature "
                        "scaling) + diagram")
    parser.add_argument("--calibration-bins", type=int, default=15)
    parser.add_argument("--top-n", type=int, default=20)
    parser.add_argument("--attention-overlays", default=None,
                        metavar="IMAGE_DIR",
                        help="write attention-rollout heat overlays for "
                        "every image in this directory (point it at a "
                        "mined failed_cases_analysis/<model>/"
                        "false_positives dir); needs "
                        "eval.checkpoint_path")
    parser.add_argument("--xprof", default=None, metavar="TRACE_DIR",
                        help="per-op device-time breakdown of a "
                        "torch.profiler trace (telemetry.profile_dir / "
                        "benchmark --profile); standalone mode — no "
                        "results dir needed")
    parser.add_argument("--xprof-steps", type=int, default=None,
                        help="with --xprof: divide totals into per-step "
                        "time (the traced execution count)")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    results_dir = args.results_dir or cfg.eval.output_dir

    if args.xprof:
        from ..analysis.xprof import print_summary, summarize_trace
        summary = summarize_trace(args.xprof, steps=args.xprof_steps)
        print_summary(summary)
        return {"xprof": summary}

    device = (resolve_device(parser, args)
              if args.latency or args.attention_overlays else None)
    out = {
        "distributions": analyze_score_distributions(results_dir),
        "failed_cases": extract_failed_cases(
            results_dir, args.test_data_dir, top_n=args.top_n),
    }
    try:
        out["summary"] = generate_summary_statistics(results_dir)
    except FileNotFoundError:
        print("model_comparison.csv missing — run evaluate-all first")

    if args.calibration:
        from ..analysis.calibration import (analyze_calibration,
                                            plot_reliability_diagram)
        out["calibration"] = analyze_calibration(
            results_dir, n_bins=args.calibration_bins)
        if pyplot("the reliability diagram"):
            out["calibration_figure"] = plot_reliability_diagram(
                results_dir)

    if args.latency:
        import torch

        from ..analysis.latency import benchmark_models
        from ..data.manifest import scan_test
        from ..models.registry import MODEL_REGISTRY, build_model

        records = scan_test(cfg.data.test_root)
        builders = {
            name: (lambda n=name: build_model(
                n, checkpoint_path=cfg.eval.checkpoint_path,
                dtype=torch.bfloat16, img_size=cfg.data.img_size,
                device=device))
            for name in MODEL_REGISTRY}
        out["latency"] = benchmark_models(
            builders, records, output_dir=results_dir)

    if args.attention_overlays and pyplot("the attention overlays"):
        from pathlib import Path

        import torch

        from ..analysis.attention_maps import generate_attention_overlays
        from ..models.registry import build_model

        src = Path(args.attention_overlays)
        exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
        paths = sorted(p for p in src.iterdir()
                       if p.suffix.lower() in exts) if src.is_dir() else []
        if not paths:
            parser.error(f"--attention-overlays: no images under {src}")
        module = build_model(
            "Custom_ViT_FineTuned",
            checkpoint_path=cfg.eval.checkpoint_path, dtype=torch.bfloat16,
            img_size=cfg.data.img_size, device=device)
        out["attention_overlays"] = generate_attention_overlays(
            module, paths, f"{results_dir}/attention_maps",
            img_size=cfg.data.img_size)

    if args.figures and pyplot("the figure suite"):
        from ..analysis.figures import generate_all_figures
        out["figures"] = generate_all_figures(
            results_dir, f"{results_dir}/figures")
    print("analysis artifacts written under", results_dir)
    return out


if __name__ == "__main__":
    main()
