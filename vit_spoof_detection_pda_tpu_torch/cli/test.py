"""`test` command (JAX ``cli/test.py``): single-model evaluation with the
test.py artifact contract (reference test.py main, :455-518), bf16 on
the card unless ``--device cpu``; under ``torchrun`` the ranks share out
the records (rank 0 writes the files)."""

from __future__ import annotations

import argparse
import os

import torch

from ..data.manifest import scan_test
from ..eval import run_single_model_eval
from ..models.registry import build_model
from .common import (add_config_args, add_fastserve_args,
                     join_process_group, resolve_config, setup_logging,
                     validate_fastserve)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a checkpoint on the test split")
    add_config_args(parser)
    parser.add_argument("--checkpoint", default=None,
                        help="torch .pth / safetensors file, or a checkpoint "
                        "directory of the port's Trainer (or an Orbax one "
                        "where orbax imports)")
    parser.add_argument("--ema", action="store_true",
                        help="score the Polyak/EMA shadow weights "
                        "(checkpoint directories from optim.ema_decay "
                        "runs)")
    parser.add_argument("--no-plots", action="store_true")
    add_fastserve_args(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = validate_fastserve(parser, args)
    cfg = resolve_config(args)
    mesh = None
    if join_process_group(device) > 1:
        # under torchrun: data-parallel scoring on the configured mesh
        from ..parallel.mesh import mesh_from_config
        mesh = mesh_from_config(cfg.sharding, device_type=device)

    ckpt = args.checkpoint or cfg.eval.checkpoint_path
    if ckpt and os.path.isdir(ckpt):
        # a training run's save_dir: the config tree's geometry (unlike the
        # fixed ViT-B/16 registry entry), and the EMA shadow on request
        from ..models.registry import (_load_checkpoint_dir,
                                       build_vit_from_config)

        module = build_vit_from_config(cfg.model, torch.bfloat16,
                                       img_size=cfg.data.img_size)
        step = _load_checkpoint_dir(module, str(ckpt), ema=args.ema)
        module = module.to(device).eval()
        print(f"loaded checkpoint step {step} from {ckpt}"
              + (" (EMA shadow)" if args.ema else ""))
    else:
        if args.ema:
            parser.error("--ema needs a checkpoint directory (the shadow "
                         "lives in the optimizer state)")
        module = build_model(
            "Custom_ViT_FineTuned", checkpoint_path=ckpt,
            dropout=cfg.model.dropout, dtype=torch.bfloat16, device=device)

    records = scan_test(cfg.data.test_root)
    metrics, paths = run_single_model_eval(
        module, records, output_dir=cfg.eval.output_dir,
        batch_size=cfg.eval.batch_size, img_size=cfg.data.img_size,
        checkpoint_name=str(ckpt), write_plots=not args.no_plots,
        fastserve=args.fastserve, mesh=mesh)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
