"""Shared CLI plumbing (JAX ``cli/common.py``): config resolution, the
device flag, joining a ``torchrun`` process group and logging setup."""

from __future__ import annotations

import argparse
import json
import logging

from ..config import Config


def add_config_args(parser: argparse.ArgumentParser):
    parser.add_argument("--preset", default="advanced-train",
                        help="config preset (advanced-train, simple-train, "
                             "test, augment, evaluate-all)")
    parser.add_argument("--config", default=None,
                        help="path to a JSON config file (overrides preset)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="PATH=VALUE", dest="overrides",
                        help="dotted config override, repeatable "
                             "(e.g. --set optim.learning_rate=1e-5)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the verb computes: the CUDA card (the "
                             "default), or the CPU on the kernels' plain "
                             "PyTorch versions")


def resolve_config(args) -> Config:
    cfg = (Config.from_json_file(args.config) if args.config
           else Config.preset(args.preset))
    overrides = {}
    for item in args.overrides:
        path, _, raw = item.partition("=")
        try:
            overrides[path] = json.loads(raw)
        except json.JSONDecodeError:
            overrides[path] = raw
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg.with_env_overrides()


def resolve_device(parser: argparse.ArgumentParser, args) -> str:
    """``"cuda"`` or ``"cpu"`` from ``--device`` and ``--interpret`` (the
    JAX flag for the kernels' plain versions, here the CPU).  Exits before
    anything is loaded when the card is asked for and this machine has
    none: nothing falls back to the CPU unasked."""
    interpret = getattr(args, "interpret", False)
    if interpret and args.device == "cuda":
        parser.error("--interpret runs the kernels' plain versions on the "
                     "CPU; it cannot combine with --device cuda")
    device = "cpu" if interpret else (args.device or "cuda")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                "this verb runs on a CUDA card and none is available; pass "
                "--device cpu to run the kernels' plain versions")
    return device


def join_process_group(device: str) -> int:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment): join the
    process group, NCCL on the card (each rank on its ``LOCAL_RANK``
    card) and gloo with ``--device cpu``, so the verb runs on the mesh
    ``sharding.*`` describes.  Returns the world size (1 otherwise)."""
    import os

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 1
    from ..parallel.mesh import init_multi_host
    return init_multi_host(backend="nccl" if device == "cuda" else "gloo")[1]


def add_fastserve_args(parser: argparse.ArgumentParser):
    parser.add_argument("--fastserve", action="store_true",
                        help="score ViT-antispoof models through the "
                        "fused-kernel bf16 serving path (bench.py "
                        "numerics; ~1e-2 score drift)")
    parser.add_argument("--interpret", action="store_true",
                        help="run the kernels' plain PyTorch versions on "
                        "the CPU (the same as --device cpu)")


def validate_fastserve(parser: argparse.ArgumentParser, args) -> str:
    """JAX ``validate_fastserve``: fail BEFORE model and data loading when
    the verb cannot run.  The serving kernels, like every kernel of the
    port, need the card unless ``--device cpu`` (or ``--interpret``) asks
    for their plain versions.  Returns the device."""
    return resolve_device(parser, args)


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    logging.getLogger().setLevel(level)


def parse_threshold(parser: argparse.ArgumentParser, raw):
    """Shared --threshold plumbing: ``None`` passes through (flag not
    given), ``"optimal"`` passes through as the resolve-from-checkpoint
    sentinel, anything else must parse to a float in (0, 1)."""
    if raw is None or raw == "optimal":
        return raw
    try:
        t = float(raw)
    except ValueError:
        parser.error(f"--threshold must be a float or 'optimal', "
                     f"got {raw!r}")
    if not 0.0 < t < 1.0:
        parser.error(f"--threshold must be in (0, 1), got {t}")
    return t


def optimal_threshold_from_metrics(metrics: dict, checkpoint: str) -> float:
    """The checkpoint's validated operating point, or a ValueError that
    names the fix (a plain exception, so a server's reload handler can
    report it; CLIs turn it into parser.error at startup)."""
    if "optimal_threshold" not in metrics:
        raise ValueError(
            f"checkpoint at {checkpoint} carries no optimal_threshold "
            "metric — train with threshold.optimize on a Trainer new "
            "enough to persist it, or pass an explicit --threshold "
            "float")
    return float(metrics["optimal_threshold"])


def warn_ema_threshold_mismatch(metrics: dict, *, ema: bool,
                                optimal: bool):
    """An EMA-trained checkpoint validates (and persists) its operating
    point on the SHADOW weights — deploying the raw iterate at that
    threshold mixes weights and operating point from different models."""
    if optimal and metrics.get("ema_decay") is not None and not ema:
        logging.getLogger(__name__).warning(
            "this checkpoint trained with optim.ema_decay=%s: its "
            "optimal_threshold was validated on the EMA shadow weights "
            "— pass --ema to deploy the weights that threshold was "
            "measured for", metrics["ema_decay"])
