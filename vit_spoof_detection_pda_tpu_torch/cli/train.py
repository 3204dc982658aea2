"""`train` command (JAX ``cli/train.py``): full fine-tune or
hyperparameter sweep (``--sweep``), on the card unless ``--device cpu``."""

from __future__ import annotations

import argparse

from ..train.driver import train_from_config
from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Fine-tune the ViT-B/16 anti-spoofing model on the "
                    "CUDA card")
    add_config_args(parser)
    parser.add_argument("--sweep", action="store_true",
                        help="run the hyperparameter sweep instead of a "
                             "single training run")
    parser.add_argument("--sweep-count", type=int, default=12)
    parser.add_argument("--max-steps-per-epoch", type=int, default=None,
                        help="debug: cap steps per epoch")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint from "
                             "checkpoint.save_dir (full state: params, "
                             "optimizer, schedule position) and continue "
                             "— the restart half of preemption-safe "
                             "training")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    if args.resume:
        cfg = cfg.with_overrides({"checkpoint.resume": True})
    if args.sweep and getattr(cfg.checkpoint, "resume", False):
        parser.error("--resume applies to a single run, not --sweep "
                     "(each trial gets its own checkpoint directory)")
    device = resolve_device(parser, args)

    if args.sweep:
        from ..train.sweep import run_sweep

        def trial(trial_cfg):
            best, _ = train_from_config(
                trial_cfg, max_steps_per_epoch=args.max_steps_per_epoch,
                device=device)
            return best

        results = run_sweep(cfg, trial, count=args.sweep_count)
        print("best:", results[0].overrides, results[0].metric)
        return results
    best, _ = train_from_config(
        cfg, max_steps_per_epoch=args.max_steps_per_epoch, device=device)
    print("best:", best)
    return best


if __name__ == "__main__":
    main()
