"""`export-serving` command (JAX ``cli/export_serving.py``): freeze a
checkpoint into a serving-artifact directory (``models/artifact.py``: a
``torch.export`` program, raw-bytes weights and a JSON descriptor).

The deployment-side counterpart of `export` (which hands weights back to
the reference's PyTorch stack): the artifact runs through
``load_serving_artifact`` with no model code, transform recipe or label
convention on the consumer's side.  The same flags as the JAX verb, plus
``--device``: where the model is built and the program traced (the card
unless ``--device cpu``).  A kernel-mode artifact exported with
``--device cpu`` (the kernels' operators give the trace their shapes;
no card is needed) runs on the card once loaded there."""

from __future__ import annotations

import argparse
import os

from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Freeze a checkpoint into a portable serving artifact")
    add_config_args(parser)
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="checkpoint directory (Trainer output) or "
                        "torch/safetensors file loadable by the registry; "
                        "optional with --model for pretrained/placeholder "
                        "entries")
    parser.add_argument("output", help="destination artifact directory")
    parser.add_argument("--model", default=None,
                        help="freeze a registry entry (e.g. "
                        "ResNet50_Pretrained, Base_ViT_Pretrained) "
                        "instead of the config-built anti-spoof ViT; "
                        "non-ViT entries support --mode module only")
    parser.add_argument("--mode", default="module",
                        choices=("module", "fastserve", "lowlat",
                                 "batch_grid"),
                        help="module = portable cpu+cuda f32 program; the "
                        "rest are the CUDA kernel serving regimes")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="freeze a static batch (required for the "
                        "kernel modes); default: symbolic — one program, "
                        "any batch (module mode only)")
    parser.add_argument("--lowlat-int8", action="store_true",
                        help="freeze the weight-only int8 encoder stream "
                        "(halves the artifact's encoder weights and the "
                        "B=1 weight traffic; opt-in quantized numerics; "
                        "--mode lowlat only)")
    parser.add_argument("--threshold", default=None,
                        help="operating point baked into the program's "
                        "pred output: a float in (0,1), or 'optimal' to "
                        "deploy the checkpoint's validated "
                        "optimal_threshold metric (checkpoint directories "
                        "saved by Trainer runs with threshold "
                        "optimization on); default 0.5")
    parser.add_argument("--ema", action="store_true",
                        help="freeze the Polyak/EMA shadow weights "
                        "(optim.ema_decay training) — the weights "
                        "validation and the persisted optimal_threshold "
                        "were measured on (checkpoint directories only)")
    parser.add_argument("--temperature", type=float, default=None,
                        help="bake probability calibration into prob1: "
                        "sigmoid(logit(p)/T) with T fitted on validation "
                        "scores; monotone — AUC/EER untouched; "
                        "--threshold then applies on the calibrated scale")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)

    if args.checkpoint is not None and not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")
    from .common import (optimal_threshold_from_metrics, parse_threshold,
                         warn_ema_threshold_mismatch)
    threshold = parse_threshold(parser, args.threshold)
    if args.temperature is not None and args.temperature <= 0:
        parser.error(f"--temperature must be > 0, got {args.temperature}")
    needs_bundle = threshold == "optimal" or args.ema
    if needs_bundle and (args.model is not None or args.checkpoint is None
                         or not os.path.isdir(args.checkpoint)):
        parser.error("--threshold optimal / --ema read a checkpoint "
                     "directory (Trainer output, without --model)")
    if args.mode != "module" and args.batch_size is None:
        parser.error(f"--mode {args.mode} runs fixed-shape CUDA kernels; "
                     "pass --batch-size")
    if args.lowlat_int8 and args.mode != "lowlat":
        parser.error("--lowlat-int8 quantizes the per-item lowlat "
                     "stream; pass --mode lowlat")
    device = resolve_device(parser, args)

    import torch

    from ..models import convert
    from ..models.artifact import save_serving_artifact

    if args.model is not None:
        from ..models.registry import MODEL_REGISTRY, build_model
        if args.model not in MODEL_REGISTRY:
            parser.error(f"unknown registry model {args.model!r}; "
                         f"choose from {sorted(MODEL_REGISTRY)}")
        entry = MODEL_REGISTRY[args.model]
        if entry.weights in ("checkpoint", "pretrained") \
                and args.checkpoint is None:
            # only entries whose contract is random weights (the SigNet_F
            # placeholder) may freeze without a weight source
            parser.error(f"{args.model} expects {entry.weights} weights; "
                         "freezing without a weight file would export "
                         "a silently-random model — pass the "
                         f"{entry.weights} path")
        kw = {}
        if args.checkpoint is not None:
            key = ("checkpoint_path" if entry.weights == "checkpoint"
                   else "pretrained_path")
            kw[key] = args.checkpoint
        module = build_model(args.model, dtype=torch.float32,
                             img_size=cfg.data.img_size,
                             device=device, **kw)
    else:
        if args.checkpoint is None:
            parser.error("a checkpoint is required without --model")
        from ..models.registry import build_vit_from_config

        module = build_vit_from_config(cfg.model, torch.float32,
                                       img_size=cfg.data.img_size)
        # strict loading, as in the `export` verb: never freeze a
        # silently-random model from a bad checkpoint path
        if os.path.isdir(args.checkpoint):
            from ..utils.checkpoint import load_checkpoint_bundle
            variables, _step, _metrics = load_checkpoint_bundle(
                args.checkpoint, ema=args.ema)
            if threshold == "optimal":
                try:
                    threshold = optimal_threshold_from_metrics(
                        _metrics, args.checkpoint)
                except ValueError as e:
                    parser.error(str(e))
            warn_ema_threshold_mismatch(
                _metrics, ema=args.ema,
                optimal=args.threshold == "optimal")
        else:
            from ..models.registry import _load_state_dict
            variables = convert.antispoof_from_torch(
                _load_state_dict(args.checkpoint))
        convert.load_jax_params(module, variables)
        module = module.to(device).eval()

    meta = save_serving_artifact(
        args.output, module, mode=args.mode, batch_size=args.batch_size,
        img_size=cfg.data.img_size, int8_weights=args.lowlat_int8,
        threshold=0.5 if threshold is None else threshold,
        temperature=args.temperature, device=device)
    b = meta["batch_size"] if meta["batch_size"] is not None else "symbolic"
    quant = ", int8 weights" if meta.get("int8_weights") else ""
    temper = (f", temperature={meta['temperature']}"
              if meta.get("temperature") is not None else "")
    print(f"serving artifact ({meta['mode']}, batch={b}, "
          f"platforms={','.join(meta['platforms'])}{quant}, "
          f"threshold={meta['threshold']}{temper}) -> "
          f"{args.output}")
    return args.output


if __name__ == "__main__":
    main()
