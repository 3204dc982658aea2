"""`export` command (JAX ``cli/export.py``): write a checkpoint in the
reference stack's ``.pth`` format (format from reference
train_advanced.py:475-489, loadable by its ``load_checkpoint``,
test.py:167-188).  Reads the port's checkpoint directories (the
Trainer's ``save_dir``; Orbax ones where ``orbax`` imports) and
``.pth``/safetensors files; the conversion is strict."""

from __future__ import annotations

import argparse
import os

from .common import add_config_args, resolve_config, setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint to the reference .pth format")
    add_config_args(parser)
    parser.add_argument("checkpoint",
                        help="checkpoint directory (Trainer output) or "
                        "torch/safetensors file loadable by the registry")
    parser.add_argument("output", help="destination .pth path")
    parser.add_argument("--ema", action="store_true",
                        help="export the Polyak/EMA shadow weights "
                        "(optim.ema_decay training) instead of the "
                        "last iterate (checkpoint directories only)")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)

    from ..models import convert

    # the registry's tolerant load (missing file -> random init + warning)
    # is the reference harness's behaviour, but exporting a partially- or
    # fully-random model because of a typo'd or truncated checkpoint must
    # not happen: this path is STRICT end to end
    if not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")

    epoch, metrics = 0, {}
    if os.path.isdir(args.checkpoint):
        from ..utils.checkpoint import load_checkpoint_bundle
        variables, _step, metrics = load_checkpoint_bundle(
            args.checkpoint, ema=args.ema)
        epoch = int(metrics.get("epoch", 0))
    elif args.ema:
        parser.error("--ema needs a checkpoint directory")
    else:
        # the registry's format dispatch (.pth / .safetensors) but a
        # STRICT conversion (a missing tensor raises), not the registry's
        # partial load
        from ..models.registry import _load_state_dict
        variables = convert.antispoof_from_torch(
            _load_state_dict(args.checkpoint))
    sd_out = convert.save_torch_checkpoint(
        args.output, variables, epoch=epoch, metrics=metrics,
        config={"model_name": cfg.model.name})
    print(f"exported {len(sd_out)} tensors (epoch {epoch}) "
          f"-> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
