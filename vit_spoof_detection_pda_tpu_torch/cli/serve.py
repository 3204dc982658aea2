"""`serve` command (JAX ``cli/serve.py``): run the HTTP scoring service
with cross-request micro-batching, over frozen serving artifacts
(export-serving output) or straight from a checkpoint directory (live
mode, no export step).

    # artifact flavor (deployment: no model code needed at runtime)
    python -m vit_spoof_detection_pda_tpu_torch serve ./artifact_lowlat \\
        ./artifact_fastserve32 --port 8417 --max-wait-ms 2

    # live flavor (research box: checkpoint -> regime table directly)
    python -m vit_spoof_detection_pda_tpu_torch serve --checkpoint ./ckpts \\
        --shapes 1,2,4,8,16

Each artifact contributes its batch shape (fixed-batch kernel artifacts)
or power-of-two buckets (symbolic-batch module artifacts); live mode
builds one program per shape on the H100's regime table
(``models/fastserve.py::auto_serving_mode``).  Concurrent requests
coalesce into the smallest shape that fits.  See ``serve/server.py`` for
the endpoints.  On the card unless ``--device cpu`` (``--interpret`` is
the same: the kernels' plain versions on the CPU).
"""

from __future__ import annotations

import argparse

from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="HTTP scoring service with cross-request "
                    "micro-batching")
    add_config_args(parser)
    parser.add_argument("artifacts", nargs="*",
                        help="artifact directories (export-serving); a "
                        "fixed-batch artifact adds its shape, a "
                        "symbolic-batch one fans across 1,2,4,... "
                        "buckets")
    parser.add_argument("--checkpoint", default=None,
                        help="live mode: serve straight from a checkpoint "
                        "directory (config-built anti-spoof ViT; "
                        "mutually exclusive with artifact dirs)")
    parser.add_argument("--shapes", default="1,2,4,8,16",
                        help="live mode: comma-separated batch shapes "
                        "to build (each gets the measured regime "
                        "winner)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8417,
                        help="0 picks an ephemeral port")
    parser.add_argument("--max-batch", type=int, default=16,
                        help="largest bucket for symbolic-batch "
                        "artifacts (fixed-batch artifacts always keep "
                        "their own shape)")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="batching window: how long the first "
                        "request of a batch waits for co-riders")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running every batch shape once at "
                        "startup (first requests pay for kernel builds)")
    parser.add_argument("--interpret", action="store_true",
                        help="run the kernels' plain PyTorch versions on "
                        "the CPU (the same as --device cpu)")
    parser.add_argument("--threshold", default=None,
                        help="live mode: the operating point for pred — "
                        "a float in (0,1), or 'optimal' to deploy the "
                        "checkpoint's validated optimal_threshold "
                        "metric (frozen artifacts carry their own "
                        "threshold from export-serving); default 0.5")
    parser.add_argument("--ema", action="store_true",
                        help="live mode: serve the Polyak/EMA shadow "
                        "weights (optim.ema_decay training) — the "
                        "weights the persisted optimal_threshold was "
                        "validated on")
    parser.add_argument("--temperature", type=float, default=None,
                        help="live mode: calibrate prob1 through "
                        "sigmoid(logit(p)/T); --threshold applies on the "
                        "calibrated scale")
    args = parser.parse_args(argv)
    setup_logging()

    if args.max_batch < 1:
        parser.error("--max-batch must be >= 1")
    if args.max_wait_ms < 0:
        parser.error("--max-wait-ms must be >= 0")
    if bool(args.artifacts) == bool(args.checkpoint):
        parser.error("pass either artifact directories OR --checkpoint")
    from .common import (optimal_threshold_from_metrics, parse_threshold,
                         warn_ema_threshold_mismatch)
    threshold = parse_threshold(parser, args.threshold)
    if args.temperature is not None and args.temperature <= 0:
        parser.error(f"--temperature must be > 0, got {args.temperature}")
    if args.artifacts and (threshold is not None or args.ema
                           or args.temperature is not None):
        parser.error("--threshold/--ema/--temperature apply to live "
                     "mode only; frozen artifacts carry their operating "
                     "point, weight choice, and calibration from "
                     "export-serving")
    shapes = None
    if not args.artifacts:
        try:
            shapes = sorted({int(s) for s in args.shapes.split(",") if s})
        except ValueError:
            parser.error(f"--shapes must be comma-separated ints, got "
                         f"{args.shapes!r}")
        if not shapes or shapes[0] < 1:
            parser.error(f"--shapes must be >= 1, got {args.shapes!r}")
    device = resolve_device(parser, args)

    from ..serve import serve
    if args.artifacts:
        serve(args.artifacts, host=args.host, port=args.port,
              max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
              warmup=not args.no_warmup, device=device)
        return

    import torch

    from ..models.convert import load_jax_params
    from ..models.registry import build_vit_from_config
    from ..serve.server import (build_programs_live,
                                make_server_from_programs, run_server)
    from ..utils.checkpoint import load_checkpoint_bundle

    cfg = resolve_config(args)
    module = build_vit_from_config(cfg.model, torch.bfloat16,
                                   img_size=cfg.data.img_size)

    def build(step=None):
        """(programs, img_size, metas) from the checkpoint directory, also
        the /admin/reload source (the latest step, so a run saving new
        bests hot-swaps into the service; --threshold optimal re-reads
        the new best's operating point).  Raises plain exceptions only:
        /admin/reload's handler turns them into a 500."""
        variables, got_step, metrics = load_checkpoint_bundle(
            args.checkpoint, step=step, ema=args.ema)
        t = threshold if threshold is not None else 0.5
        if threshold == "optimal":
            t = optimal_threshold_from_metrics(metrics, args.checkpoint)
        warn_ema_threshold_mismatch(metrics, ema=args.ema,
                                    optimal=threshold == "optimal")
        load_jax_params(module, variables)
        programs, img_size, metas = build_programs_live(
            module, shapes=shapes, img_size=cfg.data.img_size,
            threshold=t, temperature=args.temperature, device=device)
        metas[0]["checkpoint"] = {"path": args.checkpoint,
                                  "step": got_step}
        return programs, img_size, metas

    try:
        programs, img_size, metas = build()
    except ValueError as e:
        # startup: fail fast with the CLI's error (a reload later
        # re-raises through the 500 path instead)
        parser.error(str(e))
    server = make_server_from_programs(
        programs, img_size, metas, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms, rebuild=build)
    run_server(server, warmup=not args.no_warmup)


if __name__ == "__main__":
    main()
