"""`demo` command (JAX ``cli/demo.py``): the whole lifecycle in one
command on a tiny synthetic dataset, through the port's own verbs at the
JAX demo's tiny ViT geometry (D 64, depth 2, 2 heads, 32 px):

    synth data -> augment (offline store + JPEG writeback)
               -> train (checkpoints, optimal-threshold persistence)
               -> test (per-image/per-subject artifacts)
               -> evaluate-all (harness flavor + comparison reports)
               -> analyze --figures (distributions, failed cases,
                         summary, figure suite)
               -> export-serving (artifact with the validated operating
                         point baked in)
               -> describe --verify
               -> predict (artifact + image dir -> CSV)
               -> export (reference-format .pth)

Every computing stage runs on ``--device`` (the card unless ``cpu``).  The
dataset is written as PNGs through PIL, so without PIL the command exits
before any stage, naming it.

Usage:  python -m vit_spoof_detection_pda_tpu_torch demo [--out DIR]
                [--online-pool] [--keep] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .common import resolve_device


def _make_tree(root: Path, *, subjects: int, per_class: int, size: int,
               seed: int = 0):
    """<root>/<subject>/{live,spoof}/*.png with class-dependent
    brightness, so the tiny model genuinely learns the separation."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    n = 0
    for s in range(subjects):
        for cls, bright in (("live", 0.72), ("spoof", 0.28)):
            d = root / f"subj{s}" / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(per_class):
                arr = np.clip(rng.normal(bright, 0.15, (size, size, 3)),
                              0, 1)
                Image.fromarray((arr * 255).astype(np.uint8)).save(
                    d / f"{s}{i:02d}.png")
                n += 1
    return n


# tiny-but-real geometry shared by every model-building stage
def _model_sets():
    return ["--set", "model.embed_dim=64", "--set", "model.depth=2",
            "--set", "model.num_heads=2", "--set", "model.head_hidden=16",
            "--set", "model.patch_size=16"]


def _stage(name):
    print(f"\n=== demo: {name} " + "=" * max(1, 56 - len(name)),
          flush=True)
    return time.perf_counter()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the full framework lifecycle on synthetic data "
        "(tiny geometry, minutes)")
    parser.add_argument("--out", default=None,
                        help="workspace directory (default: a tmpdir; "
                        "printed at the end)")
    parser.add_argument("--online-pool", action="store_true",
                        help="also run a training epoch in the "
                        "device-pool mode (augment.device_pool)")
    parser.add_argument("--keep", action="store_true",
                        help="keep the workspace even when --out was "
                        "not given")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the stages compute: the CUDA card (the "
                             "default), or the CPU on the kernels' plain "
                             "PyTorch versions")
    args = parser.parse_args(argv)
    args.device = resolve_device(parser, args)
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise SystemExit("demo writes its synthetic dataset as PNG files "
                         "through PIL (Pillow), which is not installed")

    ws = Path(args.out) if args.out else \
        Path(tempfile.mkdtemp(prefix="pad_demo_"))
    ws.mkdir(parents=True, exist_ok=True)
    print(f"demo workspace: {ws}")
    try:
        report = _lifecycle(ws, args)
    except BaseException:
        # a mid-stage failure must not leak an unnamed tmpdir, and a
        # named workspace should be pointed at for debugging
        if not args.out and not args.keep:
            shutil.rmtree(ws, ignore_errors=True)
            print("(demo failed; tmp workspace removed — rerun with "
                  "--out or --keep to retain partial artifacts)")
        else:
            print(f"(demo failed; partial artifacts under {ws})")
        raise

    if not args.out and not args.keep:
        shutil.rmtree(ws, ignore_errors=True)
        print("(workspace removed; pass --out/--keep to retain)")
    return report


def _lifecycle(ws, args):
    t_all = time.perf_counter()
    report = {}
    dev = ["--device", args.device]

    # ---- 1. data ---------------------------------------------------------
    t = _stage("synthesize data")
    n_raw = _make_tree(ws / "raw", subjects=2, per_class=6, size=32)
    n_test = _make_tree(ws / "test", subjects=2, per_class=4, size=32,
                        seed=9)
    print(f"raw={n_raw} test={n_test} images under {ws}")
    report["data_s"] = time.perf_counter() - t

    base_sets = _model_sets() + [
        "--set", "data.img_size=32",
        "--set", "data.num_workers=2",
    ] + dev

    # ---- 2. augment ------------------------------------------------------
    t = _stage("augment (offline differential store)")
    from .augment import main as augment_main
    total = augment_main(dev + [
        "--set", f'augment.input_dir="{ws / "raw"}"',
        "--set", f'augment.output_dir="{ws / "aug"}"',
        "--set", "augment.live_augmentations=2",
        "--set", "augment.spoof_augmentations=1",
        "--set", "augment.batch_size=8",
        "--set", "augment.img_size=32",
    ])
    print(f"augmented store: {total} JPEGs")
    report["augment_s"] = time.perf_counter() - t

    # ---- 3. train --------------------------------------------------------
    t = _stage("train (fused aug+train, checkpoints)")
    from .train import main as train_main
    best = train_main(base_sets + [
        "--set", f'data.data_root="{ws / "aug"}"',
        "--set", "data.batch_size=8",
        "--set", "data.eval_batch_size=8",
        "--set", "train_aug.resize_to=40",
        "--set", "train_aug.crop_size=32",
        "--set", "optim.num_epochs=2",
        "--set", "optim.learning_rate=3e-3",
        "--set", f'checkpoint.save_dir="{ws / "ckpts"}"',
        "--set", "telemetry.log_interval=100",
    ])
    print(f"best: {json.dumps({k: round(float(v), 4) for k, v in best.items() if isinstance(v, (int, float))})}")
    report["train_s"] = time.perf_counter() - t
    report["val_f1"] = float(best.get("val_f1", float("nan")))

    if args.online_pool:
        t = _stage("train (HBM-resident device-pool mode)")
        train_main(base_sets + [
            "--set", "augment.online=true",
            "--set", "augment.device_pool=true",
            "--set", f'augment.input_dir="{ws / "raw"}"',
            "--set", "augment.live_augmentations=2",
            "--set", "augment.spoof_augmentations=1",
            "--set", "data.batch_size=8",
            "--set", "data.eval_batch_size=8",
            "--set", "optim.num_epochs=1",
            "--set", f'checkpoint.save_dir="{ws / "ckpts_pool"}"',
            "--set", "telemetry.log_interval=100",
        ])
        report["train_pool_s"] = time.perf_counter() - t

    # ---- 4. test (test.py artifact flavor) -------------------------------
    t = _stage("test (per-image / per-subject artifacts)")
    from .test import main as test_main
    metrics = test_main(base_sets + [
        "--checkpoint", str(ws / "ckpts"),
        "--set", f'data.test_root="{ws / "test"}"',
        "--set", f'eval.output_dir="{ws / "results_test"}"',
        "--set", "eval.batch_size=8",
    ])
    print(f"test AUC={metrics['auc']:.4f} acc={metrics['accuracy']:.4f}")
    report["test_auc"] = float(metrics["auc"])
    report["test_s"] = time.perf_counter() - t

    # ---- 5. evaluate-all (harness flavor) --------------------------------
    t = _stage("evaluate-all (cross-model harness)")
    from .evaluate_all import main as eval_all_main
    eval_all_main(dev + [
        "--set", f'data.test_root="{ws / "test"}"',
        "--set", f'eval.output_dir="{ws / "results"}"',
        "--set", "eval.batch_size=8",
        "--models", "SigNet_F",
    ])
    report["evaluate_all_s"] = time.perf_counter() - t

    # ---- 6. analyze ------------------------------------------------------
    t = _stage("analyze (distributions, failed cases, figures)")
    from .analyze import main as analyze_main
    out = analyze_main([
        "--results-dir", str(ws / "results"),
        "--test-data-dir", str(ws / "test"),
        "--figures",
    ])
    n_figs = sum(1 for v in out.get("figures", {}).values()
                 if v and not str(v).startswith("ERROR"))
    print(f"figures rendered: {n_figs}")
    report["analyze_s"] = time.perf_counter() - t

    # ---- 7. export-serving + describe + predict --------------------------
    t = _stage("export-serving (portable artifact)")
    from .export_serving import main as export_serving_main
    export_serving_main(base_sets + [
        str(ws / "ckpts"), str(ws / "artifact"),
        "--threshold", "optimal",
    ])
    report["export_serving_s"] = time.perf_counter() - t

    t = _stage("describe --verify")
    from .describe import main as describe_main
    describe_main([str(ws / "artifact"), str(ws / "ckpts"), "--verify"])
    report["describe_s"] = time.perf_counter() - t

    t = _stage("predict (artifact + images -> CSV)")
    from .predict import main as predict_main
    predict_main([str(ws / "artifact"), str(ws / "test"),
                  "--output", str(ws / "predictions.csv"),
                  "--num-workers", "2"] + dev)
    with open(ws / "predictions.csv") as fh:
        n_pred = sum(1 for _ in fh) - 1
    print(f"predictions.csv: {n_pred} rows")
    report["predict_s"] = time.perf_counter() - t

    # ---- 8. export (reference-format .pth) -------------------------------
    t = _stage("export (.pth for the PyTorch stack)")
    from .export import main as export_main
    export_main(base_sets + [str(ws / "ckpts"), str(ws / "export.pth")])
    report["export_s"] = time.perf_counter() - t

    # ---- summary ---------------------------------------------------------
    wall = time.perf_counter() - t_all
    print("\n=== demo complete " + "=" * 44)
    print(f"wall: {wall:.0f} s   workspace: {ws}")
    for k, v in report.items():
        if k.endswith("_s"):
            print(f"  {k[:-2]:>16s}: {v:6.1f} s")
    print(f"  val_f1={report['val_f1']:.4f} test_auc={report['test_auc']:.4f}")
    report["wall_s"] = wall
    return report


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
