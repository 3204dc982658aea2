"""`evaluate-all` command (JAX ``cli/evaluate_all.py``): cross-model
sweep + comparison reports (reference evaluate_all_models.py main,
:437-518), f32 on the card unless ``--device cpu``."""

from __future__ import annotations

import argparse
import os

from ..data.manifest import scan_test
from ..eval import run_cross_model_eval
from .common import (add_config_args, add_fastserve_args, resolve_config,
                     setup_logging, validate_fastserve)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate all registry models on the test split")
    add_config_args(parser)
    parser.add_argument("--checkpoint", default=None,
                        help="fine-tuned ViT checkpoint (.pth etc.)")
    parser.add_argument("--models", nargs="*", default=None,
                        help="subset of registry models")
    parser.add_argument("--pretrained", nargs="*", default=None,
                        metavar="NAME=PATH",
                        help="pretrained weight files for the stock "
                        "entries, e.g. Base_ViT_Pretrained=vit.safetensors "
                        "ResNet50_Pretrained=resnet50.pth (without these "
                        "the pretrained entries run RANDOM-init, loudly)")
    parser.add_argument("--ema", action="store_true",
                        help="score the Polyak/EMA shadow weights "
                        "(checkpoint directories from optim.ema_decay "
                        "runs; checkpoint-loading entries only)")
    add_fastserve_args(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = validate_fastserve(parser, args)
    cfg = resolve_config(args)

    pretrained = {}
    for item in args.pretrained or []:
        name, _, path = item.partition("=")
        if not path:
            parser.error(f"--pretrained expects NAME=PATH, got {item!r}")
        pretrained[name] = path

    ckpt = args.checkpoint or cfg.eval.checkpoint_path
    if args.ema and not (ckpt and os.path.isdir(ckpt)):
        # fail fast: inside the harness the per-model error isolation
        # would swallow build_model's ValueError and the run would
        # "succeed" having scored nothing
        parser.error("--ema needs a checkpoint directory (the shadow "
                     f"lives in the optimizer state); got {ckpt!r}")

    records = scan_test(cfg.data.test_root)
    results = run_cross_model_eval(
        records, output_dir=cfg.eval.output_dir,
        checkpoint_path=ckpt,
        pretrained_paths=pretrained or None,
        model_names=args.models, batch_size=cfg.eval.batch_size,
        img_size=cfg.data.img_size, fastserve=args.fastserve,
        ema=args.ema, thresholds=cfg.eval.thresholds,
        cm_thresholds=cfg.eval.extra_cm_thresholds, device=device)
    for name, s in results.items():
        print(f"{name}: AUC={s['roc_auc']:.4f} EER={s['eer']:.4f}")
    return results


if __name__ == "__main__":
    main()
