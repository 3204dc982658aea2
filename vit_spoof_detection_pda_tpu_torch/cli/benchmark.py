"""`benchmark` command (JAX ``cli/benchmark.py``): throughput and
device latency of the flagship model, and the training step, on the
card unless ``--device cpu``.  The same flags and the same
``parser.error`` rules as the JAX verb; each mode prints one JSON line
with the JAX verb's keys (plus ``device``)."""

from __future__ import annotations

import argparse
import json

import torch

from ..analysis.latency import benchmark_device_latency, benchmark_throughput
from ..models.registry import build_model
from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)

# the reference's per-model bs=1 benchmark rows
# (results/inference_time_benchmark.json, RTX A4500,
# additional_analysis.py:259-315) — the targets --all-models reports
# against; SigNet_F is excluded like the reference's own table.
REF_B1_MS = {"Custom_ViT_FineTuned": 5.43, "Base_ViT_Pretrained": 4.86,
             "ResNet50_Pretrained": 4.96}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Throughput benchmark of the flagship ViT")
    add_config_args(parser)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=None,
                        help="timed iterations (throughput mode; default 20)")
    parser.add_argument("--model", default="Custom_ViT_FineTuned")
    parser.add_argument("--fastserve", action="store_true",
                        help="time the bf16 serving fast path (the "
                             "attention- and MLP-block kernels, tanh GELU, "
                             "folded normalization) — flagship ViT only")
    parser.add_argument("--device-latency", action="store_true",
                        help="per-execution device latency at --batch-size "
                             "(CUDA events over runs of n1 and 3 n1; bs=1 "
                             "is the reference's 5.43 ms single-image "
                             "protocol)")
    parser.add_argument("--lowlat", action="store_true",
                        help="with --device-latency: time the single-kernel "
                             "latency mode (ops/lowlat.py; image->logits in "
                             "ONE launch when the shape allows fold-ends, "
                             "else the whole-encoder kernel with plain "
                             "ends) — flagship ViT only")
    parser.add_argument("--lowlat-encoder-only", action="store_true",
                        help="with --lowlat: force the encoder-only kernel "
                             "(plain stem/head) instead of fold-ends")
    parser.add_argument("--lowlat-batch-grid", action="store_true",
                        help="with --lowlat: the batch-grid kernel (weights "
                             "stream once per 2-image chunk instead of "
                             "once per image) — the B=2..15 regime; "
                             "anti-spoof head only")
    parser.add_argument("--lowlat-int8", action="store_true",
                        help="with --lowlat: stream the encoder weights "
                             "weight-only int8 (half the weight bytes of "
                             "the B=1 kernel; opt-in quantized numerics)")
    parser.add_argument("--interpret", action="store_true",
                        help="run the kernels' plain PyTorch versions on "
                             "the CPU (the same as --device cpu)")
    parser.add_argument("--n1", type=int, default=200,
                        help="run length for --device-latency (times n1 "
                             "then 3*n1 executions, 3 repeats)")
    parser.add_argument("--loop-iters", type=int, default=0,
                        help="with --device-latency: capture this many "
                             "executions in one CUDA graph and time its "
                             "replays (dispatch-free device latency)")
    parser.add_argument("--artifact", default=None,
                        help="with --device-latency: time a FROZEN "
                             "serving artifact directory (export-serving) "
                             "instead of a live model; a fixed-batch "
                             "artifact pins --batch-size")
    parser.add_argument("--train-step", action="store_true",
                        help="time the TRAIN step (forward + backward + "
                             "clip + AdamW + metrics) at --batch-size on "
                             "synthetic batches — the trainer's hot loop; "
                             "flagship ViT only.  model.gelu / "
                             "loss.loss_type config overrides apply")
    parser.add_argument("--no-fused-forward", action="store_true",
                        help="with --train-step: force the plain module "
                             "forward instead of the fused training "
                             "forward (A/B)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the "
                             "benchmarked program into DIR — works in "
                             "every mode")
    parser.add_argument("--all-models", action="store_true",
                        help="with --device-latency: measure EVERY row of "
                             "the reference's per-model benchmark "
                             "(Custom ViT / Base ViT / ResNet50) on the "
                             "module-parity path and report speedups vs "
                             "its RTX A4500 numbers")
    args = parser.parse_args(argv)
    if args.train_step:
        if (args.device_latency or args.fastserve or args.lowlat
                or args.all_models or args.artifact):
            parser.error("--train-step is its own mode; drop the "
                         "inference-mode flags")
        if args.model != "Custom_ViT_FineTuned":
            parser.error("--train-step times the flagship ViT training "
                         "program; --model does not apply")
    if args.no_fused_forward and not args.train_step:
        parser.error("--no-fused-forward is a --train-step option")
    if args.all_models:
        if not args.device_latency:
            parser.error("--all-models is a --device-latency mode")
        if args.fastserve or args.lowlat:
            parser.error("--all-models times the module-parity path for "
                         "every model; use --model with "
                         "--fastserve/--lowlat for the fused flavors")
    if args.lowlat and not args.device_latency:
        parser.error("--lowlat is a latency mode; combine with "
                     "--device-latency (batched throughput stays on the "
                     "per-layer --fastserve path, which wins at B>=16)")
    if args.lowlat_batch_grid and not args.lowlat:
        parser.error("--lowlat-batch-grid is a --lowlat flavor; add "
                     "--lowlat (otherwise the module path would be "
                     "timed and reported as batch-grid numbers)")
    if args.lowlat_int8 and not args.lowlat:
        parser.error("--lowlat-int8 is a --lowlat flavor; add --lowlat")
    if args.lowlat_int8 and args.lowlat_batch_grid:
        parser.error("--lowlat-int8 quantizes the per-item stream; the "
                     "batch-grid pack stays full-precision")
    if args.lowlat_batch_grid and args.lowlat_encoder_only:
        parser.error("--lowlat-batch-grid and --lowlat-encoder-only "
                     "select different kernels; pick one")
    if args.artifact:
        if not args.device_latency:
            parser.error("--artifact is a --device-latency mode")
        if args.fastserve or args.lowlat or args.all_models:
            parser.error("--artifact times the frozen program as "
                         "exported; drop the live-path flags (the mode "
                         "was chosen at export time)")
        if args.iters is not None:
            parser.error("--iters applies to throughput mode only; "
                         "--device-latency run length is --n1")
        if args.interpret:
            parser.error("--interpret cannot apply to a frozen program "
                         "(the mode was compiled at export time)")
    # fail BEFORE the model load, like validate_fastserve
    device = resolve_device(parser, args)
    setup_logging()
    cfg = resolve_config(args)

    from ..utils.profiling import profile_trace
    with profile_trace(args.profile):
        return _dispatch(args, cfg, parser, device)


def _dispatch(args, cfg, parser, device):
    """Run the selected benchmark mode (split out so --profile wraps
    exactly the timed program, whatever the mode)."""
    if args.train_step:
        from ..analysis.latency import benchmark_train_step
        from ..models.vit import ViTAntiSpoof
        module = ViTAntiSpoof(dtype=torch.bfloat16, gelu=cfg.model.gelu,
                              img_size=cfg.data.img_size)
        out = benchmark_train_step(
            module, batch_size=args.batch_size,
            img_size=cfg.data.img_size, iters=args.iters or 10,
            loss_type=cfg.loss.loss_type, gelu=cfg.model.gelu,
            fused=False if args.no_fused_forward else None, device=device)
        print(json.dumps(out))
        return out

    if args.artifact:
        from ..models.artifact import load_serving_artifact
        art = load_serving_artifact(args.artifact, device=device)
        bs = art.meta.get("batch_size") or args.batch_size
        out = benchmark_device_latency(
            lambda _w, batch: art(batch), None, batch_size=bs,
            img_size=art.meta.get("img_size", 224), n1=args.n1,
            loop_iters=args.loop_iters, device=device)
        out["artifact_mode"] = art.meta["mode"]
        print(json.dumps(out))
        return out

    if args.all_models:
        from ..eval.runner import make_infer_fn
        out = {}
        for name, ref_ms in REF_B1_MS.items():
            module = build_model(
                name, checkpoint_path=cfg.eval.checkpoint_path,
                dtype=torch.bfloat16, img_size=cfg.data.img_size,
                device=device)
            infer = make_infer_fn(module)
            r = benchmark_device_latency(
                lambda _v, batch: infer(batch), None,
                batch_size=args.batch_size, img_size=cfg.data.img_size,
                n1=args.n1, loop_iters=args.loop_iters, device=device)
            r["ref_ms_rtx_a4500"] = ref_ms
            r["speedup_vs_ref"] = round(ref_ms / r["ms_per_image"], 2)
            out[name] = r
            print(name, json.dumps(r))
        print(json.dumps(out))
        return out

    module = build_model(
        args.model, checkpoint_path=cfg.eval.checkpoint_path,
        dtype=torch.bfloat16, img_size=cfg.data.img_size, device=device)
    if args.device_latency:
        if args.iters is not None:
            parser.error("--iters applies to throughput mode only; "
                         "--device-latency run length is --n1")
        from ..eval.runner import make_infer_fn
        variables = None
        if args.lowlat:
            infer, variables = _lowlat_infer(args, parser, module, device)
        elif args.fastserve:
            from ..eval.runner import make_fastserve_infer
            fast = make_fastserve_infer(module)

            def infer(_v, batch_u8):
                return fast(batch_u8)
        else:
            plain = make_infer_fn(module)

            def infer(_v, batch):
                return plain(batch)
        out = benchmark_device_latency(
            infer, variables, batch_size=args.batch_size,
            img_size=cfg.data.img_size, n1=args.n1,
            loop_iters=args.loop_iters, device=device)
    else:
        out = benchmark_throughput(module, batch_size=args.batch_size,
                                   img_size=cfg.data.img_size,
                                   iters=args.iters or 20,
                                   fastserve=args.fastserve)
    print(json.dumps(out))
    return out


def _lowlat_infer(args, parser, module, device):
    """``(infer(prepared, batch_u8), prepared)`` of the --lowlat flavors
    on the whole-encoder kernels (kernel 10 per item, fold-ends or
    encoder-only; kernel 11 per 2-item chunk).  ``ViTLinearHead`` takes
    the encoder-only kernel and scores softmax column 1."""
    from ..models.convert import antispoof_from_torch, vit_linear_from_torch
    from ..models.fastserve import (prepare_lowlat, serving_forward_lowlat,
                                    serving_forward_lowlat_batch,
                                    serving_forward_lowlat_linear)
    from ..models.vit import ViTAntiSpoof, ViTLinearHead, fold_normalization

    if not isinstance(module, (ViTAntiSpoof, ViTLinearHead)):
        parser.error("--lowlat supports the ViT-family models "
                     f"only; got {type(module).__name__}")
    antispoof = isinstance(module, ViTAntiSpoof)
    if args.lowlat_batch_grid and not antispoof:
        parser.error("--lowlat-batch-grid packs the anti-spoof "
                     "head layout; use plain --lowlat for "
                     f"{type(module).__name__}")
    if args.lowlat_int8 and not antispoof:
        parser.error("--lowlat-int8 packs the anti-spoof layout; use plain "
                     f"--lowlat for {type(module).__name__}")
    to_tree = antispoof_from_torch if antispoof else vit_linear_from_torch
    folded = fold_normalization(to_tree(
        {k: v.float() for k, v in module.state_dict().items()}))
    geom = dict(num_heads=module.num_heads, patch_size=module.patch_size,
                norm_eps=module.norm_eps, device=device)
    prepared = prepare_lowlat(
        folded["params"], depth=module.depth,
        fold_ends=antispoof and not args.lowlat_encoder_only,
        batch_grid=args.lowlat_batch_grid,
        per_item=not args.lowlat_batch_grid,
        int8_weights=args.lowlat_int8, device=device)
    print("lowlat flavor:",
          "batch-grid (per-chunk weight streaming)"
          if args.lowlat_batch_grid else
          "fold-ends (image->logits single kernel)"
          if "aux" in prepared else
          "encoder-only (plain stem/head)")
    if not antispoof:
        def infer(prep, batch_u8):
            return {"prob1": serving_forward_lowlat_linear(
                prep, batch_u8, **geom)[:, 1]}
        return infer, prepared
    forward = (serving_forward_lowlat_batch if args.lowlat_batch_grid
               else serving_forward_lowlat)

    def infer(prep, batch_u8):
        return {"prob1": forward(prep, batch_u8, **geom)}

    return infer, prepared


if __name__ == "__main__":
    main()
