"""Inference latency / throughput benchmarks (JAX ``analysis/latency.py``).

Two protocols:

1. :func:`benchmark_single_image` — the reference's protocol
   (additional_analysis.py:184-315): N images, one at a time, wall-clock
   per image, batch size 1; stats -> ``inference_time_benchmark.json`` +
   ``inference_time_comparison.csv`` (same keys/columns).  Decoding sits
   outside the timer, as in the reference; the timed region is the upload,
   the normalize and the forward, ended by a fetch of the score.
2. :func:`benchmark_throughput` — steady-state batched inference with
   on-device preprocessing.

Device times (:func:`benchmark_device_latency`) come from CUDA events on
the card; on the CPU (``device="cpu"``, the plain versions) the host
clock stands in, and every result names the device it ran on.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data import loader
from ..data.manifest import Record
from ..eval.runner import make_infer_fn, module_device

log = logging.getLogger(__name__)


def _device_name(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed_s(device, fn) -> float:
    """Seconds ``fn()`` takes on ``device``: between two CUDA events on
    the card, on the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _stats_ms(times_s) -> dict:
    t = np.asarray(times_s) * 1000.0
    return {
        "mean_time_ms": float(np.mean(t)),
        "std_time_ms": float(np.std(t)),
        "min_time_ms": float(np.min(t)),
        "max_time_ms": float(np.max(t)),
        "median_time_ms": float(np.median(t)),
        "fps": float(1000.0 / np.mean(t)),
        "total_samples": len(t),
    }


def benchmark_single_image(module, records: Sequence[Record], *,
                           n_images: int = 100, img_size: int = 224
                           ) -> dict:
    """Per-image wall-clock incl. preprocessing, bs=1 (reference
    protocol: 50 live + 50 spoof, additional_analysis.py:259-277)."""
    live = [r for r in records if r.label == 1][: n_images // 2]
    spoof = [r for r in records if r.label == 0][: n_images // 2]
    sample = live + spoof
    infer = make_infer_fn(module)

    # warm up outside the timed region (the reference's first-call CUDA
    # warmup is likewise excluded by its warm cache)
    warm = loader.decode_image(sample[0].path, img_size)
    infer(warm[None])["prob1"].cpu()

    times = []
    for r in sample:
        u8 = loader.decode_image(r.path, img_size)  # outside the timer,
        t0 = time.perf_counter()                    # like Image.open
        infer(u8[None])["prob1"].cpu()              # bound by the fetch
        times.append(time.perf_counter() - t0)
    return _stats_ms(times)


def benchmark_throughput(module, *, batch_size: int = 128,
                         img_size: int = 224, iters: int = 20,
                         fastserve: bool = False) -> dict:
    """Steady-state img/s with on-device preprocessing, on the module's
    device.  ``fastserve=True`` times the bf16 serving path instead
    (``models/fastserve.py``: folded normalization, the attention- and
    MLP-block kernels, tanh GELU); the flagship ViT only."""
    dev = module_device(module)
    if fastserve:
        from ..eval.runner import make_fastserve_infer
        infer = make_fastserve_infer(module)
    else:
        infer = make_infer_fn(module)
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(
        0, 256, (batch_size, img_size, img_size, 3), dtype=np.uint8)).to(dev)
    infer(batch)["prob1"].cpu()                      # warmup

    t0 = time.perf_counter()
    outs = [infer(batch) for _ in range(iters)]
    outs[-1]["prob1"].cpu()
    dt = (time.perf_counter() - t0) / iters
    out = {
        "batch_size": batch_size,
        "ms_per_batch": dt * 1000.0,
        "images_per_second": batch_size / dt,
        "device": _device_name(dev),
    }
    fl = vit_flops_per_image(module, img_size)
    if fl is not None:
        out["achieved_tflops"] = float(
            f"{fl * out['images_per_second'] / 1e12:.3g}")
    return out


def vit_flops_per_image(module, img_size: int) -> Optional[float]:
    """Analytic FORWARD FLOPs/image for the ViT family (multiply-adds
    count 2): patch-embed GEMM + per-layer QKV / QK^T / AV / proj / MLP
    GEMMs + head (LN/softmax/GELU vector FLOPs are <1% and omitted).
    ViT-B/16 @ 224 -> ~35.2 GFLOP.  None for non-ViT modules."""
    p = getattr(module, "patch_size", None)
    d = getattr(module, "embed_dim", None)
    depth = getattr(module, "depth", None)
    if not (p and d and depth):
        return None
    t = (img_size // p) ** 2 + 1
    mlp = int(d * getattr(module, "mlp_ratio", 4.0))
    per_layer = (2 * t * d * 3 * d        # fused QKV
                 + 2 * t * t * d          # Q K^T
                 + 2 * t * t * d          # A V
                 + 2 * t * d * d          # proj
                 + 2 * t * d * mlp * 2)   # fc1 + fc2
    embed = 2 * (t - 1) * (p * p * 3) * d
    hidden = getattr(module, "hidden", 0)
    ncls = getattr(module, "num_classes", 2)
    head = 2 * d * hidden + 2 * hidden * ncls if hidden else 2 * d * ncls
    return float(embed + depth * per_layer + head)


def benchmark_train_step(module=None, *, batch_size: int = 128,
                         img_size: int = 224, iters: int = 10,
                         loss_type: str = "focal", gelu: str = "erf",
                         fused: Optional[bool] = None, device=None) -> dict:
    """Steady-state TRAIN-step time: forward + backward + clip + AdamW +
    metrics (``train/step.py``) on synthetic normalized batches — the
    trainer's hot loop (reference train_advanced.py:315-365).

    ``fused`` forces the fused training forward (``models/fasttrain.py``,
    the training kernels) on or off (off: the module path, kernel 8 and
    the attention backward); default on for the port's ViTAntiSpoof.
    ``gelu="tanh"`` selects the serving-parity GELU like ``model.gelu``.
    Runs on the card unless ``device="cpu"``."""
    from ..device import resolve_device
    from ..models.vit import ViTAntiSpoof
    from ..ops import losses
    from ..train.state import create_train_state, make_optimizer
    from ..train.step import make_train_step

    device = resolve_device(device)
    if module is None:
        module = ViTAntiSpoof(dtype=torch.bfloat16, gelu=gelu,
                              img_size=img_size)
    if fused is None:
        from ..models.fasttrain import fast_apply_available
        fused = fast_apply_available(module)
    if fused:
        from ..models.fasttrain import make_apply
        apply_fn = make_apply(module)
    else:
        from ..train.trainer import module_tree_apply
        module.to(device)
        apply_fn = module_tree_apply(module)
    state = create_train_state(module, make_optimizer(3e-4), 0,
                               apply_fn=apply_fn, device=device)
    step = make_train_step(losses.make_loss_fn(loss_type))

    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.standard_normal(
            (batch_size, img_size, img_size, 3)).astype(np.float32)
        ).to(device),
        "label": torch.from_numpy(rng.integers(
            0, 2, batch_size).astype(np.int64)).to(device),
    }
    state, metrics = step(state, batch)          # warmup
    float(metrics["loss"])

    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
    float(metrics["loss"])                       # one scalar sync bound
    dt = (time.perf_counter() - t0) / iters
    out = {
        "batch_size": batch_size,
        "fused_forward": bool(fused),
        "gelu": gelu,
        "ms_per_step": dt * 1000.0,
        "images_per_second": batch_size / dt,
        "device": _device_name(device),
    }
    fl = vit_flops_per_image(module, img_size)
    if fl is not None:
        # fwd + bwd ~ 3x fwd GEMM FLOPs (dL/dx and dL/dW each re-run
        # every GEMM)
        out["achieved_tflops"] = float(
            f"{3 * fl * out['images_per_second'] / 1e12:.3g}")
    from ..utils.profiling import device_memory_gb
    mem = device_memory_gb() if device.type == "cuda" else None
    if mem is not None:
        out["device_mem_gb"] = round(mem, 3)
    return out


def benchmark_device_latency(infer, variables, *, batch_size: int = 1,
                             img_size: int = 224, n1: int = 200,
                             repeats: int = 3, loop_iters: int = 0,
                             device=None) -> dict:
    """Steady-state per-execution device latency at a given batch size:
    ``infer(variables, batch_u8) -> {"prob1": ...}``.

    The run-length protocol of the JAX package: N then 3N executions, each
    run timed whole, per-exec = (t(3N) - t(N)) / (2N), the median of
    ``repeats``.  On the card each run is timed between CUDA events (the
    JAX package differences host times to remove its relay's round trip;
    the differencing here removes the fixed cost of a run).

    ``loop_iters > 0``: the counterpart of the JAX package's one compiled
    ``fori_loop`` program: ``loop_iters`` executions captured once in a
    CUDA graph, each run replaying it, so no host dispatch is timed.  On
    the CPU the executions run back to back instead."""
    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(
        0, 256, (batch_size, img_size, img_size, 3), dtype=np.uint8)).to(dev)
    infer(variables, batch)["prob1"].cpu()       # warm up

    def summary(per_exec_s, **extra):
        ms = float(np.median(per_exec_s)) * 1000.0
        return {"batch_size": batch_size, "ms_per_exec": ms,
                "ms_per_image": ms / batch_size,
                "images_per_second": 1000.0 * batch_size / ms,
                **extra, "device": _device_name(dev)}

    if loop_iters:
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):         # warm up off the default
                infer(variables, batch)           # stream before capture
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(loop_iters):
                    infer(variables, batch)
            body = graph.replay
        else:
            def body():
                for _ in range(loop_iters):
                    infer(variables, batch)
        body()
        _sync(dev)

        def run(n):
            def go():
                for _ in range(n):
                    body()
            return _elapsed_s(dev, go)

        k1 = max(1, n1 // loop_iters)
        times = []
        for _ in range(repeats):
            t1, t2 = run(k1), run(3 * k1)
            times.append((t2 - t1) / (2 * k1 * loop_iters))
        return summary(times, loop_iters=loop_iters,
                       dispatch_free=dev.type == "cuda")

    def run(n):
        return _elapsed_s(dev, lambda: [infer(variables, batch)
                                        for _ in range(n)])

    times = []
    for _ in range(repeats):
        t1, t2 = run(n1), run(3 * n1)
        times.append((t2 - t1) / (2 * n1))
    return summary(times)


def benchmark_models(model_builders: Dict[str, callable],
                     records: Sequence[Record], *, output_dir: str,
                     n_images: int = 100, batch_size: int = 128,
                     img_size: int = 224,
                     include_throughput: bool = True) -> dict:
    """Run both protocols over ``{name: () -> module}``; writes the
    reference-format artifacts.

    ``inference_time_benchmark.json`` keeps EXACTLY the reference's seven
    stat keys per model (additional_analysis.py:279-300); the batched
    throughput goes to its own ``throughput_benchmark.json``; the CSV is
    written without pandas, as ``eval/single.py`` writes its tables."""
    from ..eval.single import write_csv

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = {}
    throughput = {}
    for name, build in model_builders.items():
        try:
            module = build()
            r = benchmark_single_image(module, records, n_images=n_images,
                                       img_size=img_size)
            if include_throughput:
                throughput[name] = benchmark_throughput(
                    module, batch_size=batch_size, img_size=img_size)
            results[name] = r
            log.info("%s: %.2f ms/img (%.1f FPS)%s", name,
                     r["mean_time_ms"], r["fps"],
                     f", batched {throughput[name]['images_per_second']:.0f}"
                     f" img/s" if include_throughput else "")
        except Exception as e:                       # noqa: BLE001
            log.exception("latency benchmark failed for %s: %s", name, e)

    with open(out / "inference_time_benchmark.json", "w") as f:
        json.dump(results, f, indent=2)
    if throughput:
        with open(out / "throughput_benchmark.json", "w") as f:
            json.dump(throughput, f, indent=2)
    rows = sorted(results.items(), key=lambda kv: kv[1]["mean_time_ms"])
    write_csv(out / "inference_time_comparison.csv", {
        "model": [n for n, _ in rows],
        "mean_ms": [r["mean_time_ms"] for _, r in rows],
        "fps": [r["fps"] for _, r in rows],
        "std_ms": [r["std_time_ms"] for _, r in rows]})
    return results
