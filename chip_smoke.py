#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``csrc/`` at first use, then
runs these phases, each printing one JSON line and raising on failure:

1. device   nvidia-smi's name and power limit, torch's view of the card.
2. build    the nvcc build (one process per kernel source, in parallel).
3. kernels  each kernel against its plain PyTorch version on the card in
            bf16: full ViT-B shapes (B = 2, 3 and the main path's 128;
            Tp 200, valid_len 197) and a ragged one (Tp 40, valid_len 33,
            D 64, 4 heads).  Tolerance: 2 bf16 ulps at the largest output
            magnitude, since the two sum in different f32 orders and a
            flipped rounding of an intermediate (qkv, softmax weights,
            GELU output) moves the output by about one ulp.
4. slice    a ViT-B/16 ViTAntiSpoof (12 layers, random weights from a
            numpy seed, loaded through models/convert.py) served by
            make_serving_fn at B = 128 and B = 32 on 224x224 uint8
            faces.  Each kernel's launch count must rise by exactly 12
            per forward.  Scores are held against the same forward with
            both blocks on their plain versions on the card, and against
            the port's f32 module forward (TF32 off): max |diff| within
            5e-2 and mean |diff| within 1e-2.  That is the bf16 noise
            level of 12 full-width layers, not an ulp check: two bf16
            evaluations that round at the same points but sum in another
            f32 order drift apart through the layers about as far as
            either drifts from f32 (phase 3 holds each kernel to 2 ulps
            per layer).  A wrong weight, layer or mask moves these scores
            (std ~0.17) far more.
5. serving  build_programs_live(shapes=(32, 128)) behind a MicroBatcher:
            300 single-image requests from 8 threads, each answer held
            against the direct serving_forward score of that image.
6. times    CUDA-event medians after warm-up: each kernel beside its
            plain version and its bound at the main path's shapes, the
            stem and head, and end-to-end img/s at B = 128.

Then it prints the kernel table as one JSON line, the card's name and
power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with 2
before printing any result.  TF32 is turned off wherever a plain version
or the f32 reference runs (device.exact_f32_matmul).
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vit_spoof_detection_pda_tpu_torch.device import exact_f32_matmul
from vit_spoof_detection_pda_tpu_torch.models import fastserve
from vit_spoof_detection_pda_tpu_torch.models.convert import load_jax_params
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof
from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.ops import attention as att
from vit_spoof_detection_pda_tpu_torch.ops.image import normalize, to_float
from vit_spoof_detection_pda_tpu_torch.serve import (MicroBatcher,
                                                     build_programs_live)

SEED = 0
IMG, PATCH, D, HEADS, DEPTH, HIDDEN, HEAD_HIDDEN = 224, 16, 768, 12, 12, 3072, 512
T = (IMG // PATCH) ** 2 + 1          # 197 tokens
TP = att._round_up(T, 8)             # 200-row padded stream
MAIN_B = 128
SCORE_TOL = 5e-2                     # max |diff| of P(live), see phase 4
SCORE_MEAN_TOL = 1e-2                # mean |diff| of P(live)
SERVE_TOL = 1e-3
PEAK_BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3

KERNELS = {
    "attention_block": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/attention_block.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/attention.py:412"),
    "mlp_block": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/mlp_block.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/attention.py:532"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_blocks():
    """Run the serving path's two blocks on their plain versions (the
    card's bf16 reference of the whole forward); restores the kernels."""
    saved = fastserve.fused_attention_block_padded, fastserve.fused_mlp_block
    fastserve.fused_attention_block_padded = (
        att.fused_attention_block_padded_plain)
    fastserve.fused_mlp_block = att.fused_mlp_block_plain
    try:
        yield
    finally:
        (fastserve.fused_attention_block_padded,
         fastserve.fused_mlp_block) = saved


def bf16_tol(want: torch.Tensor) -> float:
    """2 bf16 ulps at the largest magnitude of ``want``."""
    amax = want.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7) if amax else 0.0


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def block_inputs(rng, b, tp, d, hidden, dev):
    """Residual stream and one layer's weights, numpy-seeded: x ~ N(0, 1),
    matrices scaled by fan-in, LN scales near 1."""
    def n(*shape, std=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def mat(*shape):
        return torch.from_numpy(n(*shape, std=shape[0] ** -0.5)).to(
            dev, torch.bfloat16)

    def vec(size, base=0.0, std=0.1):
        return torch.from_numpy(base + n(size, std=std)).to(dev)

    attn = dict(xp=torch.from_numpy(n(b, tp, d)).to(dev, torch.bfloat16),
                ln_scale=vec(d, 1.0), ln_bias=vec(d), w_qkv=mat(d, 3 * d),
                b_qkv=vec(3 * d), w_proj=mat(d, d), b_proj=vec(d))
    mlp = dict(x=attn["xp"], ln_scale=vec(d, 1.0), ln_bias=vec(d),
               w_fc1=mat(d, hidden), b_fc1=vec(hidden),
               w_fc2=mat(hidden, d), b_fc2=vec(d))
    return attn, mlp


def random_params(rng) -> dict:
    """ViT-B/16 ViTAntiSpoof parameters in the JAX layout: encoder
    matrices N(0, 0.02), LN scales near 1, head sized so scores spread."""
    def n(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(i, o, std):
        return {"kernel": n(i, o, std=std), "bias": n(o, std=0.02)}

    def ln(dim):
        return {"scale": 1.0 + n(dim, std=0.1), "bias": n(dim, std=0.05)}

    vit = {"patch_embed": dense(PATCH * PATCH * 3, D, 0.02),
           "cls_token": n(1, 1, D, std=0.02),
           "pos_embed": n(1, T, D, std=0.02), "norm": ln(D)}
    for i in range(DEPTH):
        vit[f"block{i}"] = {
            "norm1": ln(D),
            "attn": {"qkv": dense(D, 3 * D, 0.02), "proj": dense(D, D, 0.02)},
            "norm2": ln(D),
            "mlp": {"fc1": dense(D, HIDDEN, 0.02),
                    "fc2": dense(HIDDEN, D, 0.02)}}
    head = {"norm": ln(D), "fc1": dense(D, HEAD_HIDDEN, D ** -0.5),
            "fc2": dense(HEAD_HIDDEN, 2, 0.1)}
    return {"params": {"vit": vit, "head": head}}


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, *, windows=5, per_window=10, warmup=3) -> float:
    """Median over ``windows`` of the mean time of ``per_window`` calls
    queued back to back between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per_window)
    return statistics.median(out)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(b, tp, d, heads):
    flops = 2 * b * tp * d * 4 * d + 4 * b * heads * tp * tp * (d // heads)
    nbytes = 2 * b * tp * d * 2 + (3 * d * d + d * d) * 2 + 6 * d * 4
    return flops, nbytes


def mlp_work(rows, d, hidden):
    flops = 4 * rows * d * hidden
    nbytes = 2 * rows * d * 2 + 2 * d * hidden * 2 + (3 * d + hidden) * 4
    return flops, nbytes


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    t0 = time.perf_counter()
    compiled = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.split(":", 1)[-1].strip()
                    for ln in _build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name in _build.KERNELS}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "compiled": compiled, "ptxas": ptxas})


def phase_kernels(dev) -> dict:
    """Kernel vs plain at every case; returns the main path's errors."""
    rng = np.random.default_rng(SEED)
    cases = [("vit_b_b2", 2, TP, T, D, HEADS, HIDDEN),
             ("vit_b_b3", 3, TP, T, D, HEADS, HIDDEN),
             ("ragged", 2, 40, 33, 64, 4, 256),
             ("main_path_b128", MAIN_B, TP, T, D, HEADS, HIDDEN)]
    main_err = {}
    for label, b, tp, valid, d, heads, hidden in cases:
        a_in, m_in = block_inputs(rng, b, tp, d, hidden, dev)
        got = {"attention_block": att.fused_attention_block_padded(
                   **a_in, num_heads=heads, valid_len=valid),
               "mlp_block": att.fused_mlp_block(**m_in)}
        want = {"attention_block": att.fused_attention_block_padded_plain(
                    **a_in, num_heads=heads, valid_len=valid),
                "mlp_block": att.fused_mlp_block_plain(**m_in)}
        torch.cuda.synchronize()
        for name in KERNELS:
            g, w = got[name].float(), want[name].float()
            err = (g - w).abs().max().item()
            mean_err = (g - w).abs().mean().item()
            tol = bf16_tol(w)
            ok = bool(torch.isfinite(g).all()) and err <= tol
            emit({"phase": "kernels", "case": label, "kernel": name,
                  "shape": list(got[name].shape), "valid_len": valid,
                  "max_abs_err": err, "mean_abs_err": mean_err,
                  "mean_signed_err": (g - w).mean().item(), "tol": tol,
                  "ok": ok})
            if not ok:
                raise AssertionError(
                    f"{name} disagrees with its plain version on {label}: "
                    f"max |diff| {err} > {tol}")
            if label.startswith("main_path"):
                main_err[name] = err
        del a_in, m_in, got, want
    return main_err


def phase_slice(dev):
    rng = np.random.default_rng(SEED + 1)
    params = random_params(rng)
    model = load_jax_params(ViTAntiSpoof(gelu="tanh").eval(), params)
    serve128 = fastserve.make_serving_fn(model, batch_size=MAIN_B)
    serve32 = fastserve.make_serving_fn(model, batch_size=32)
    u8 = rng.integers(0, 256, (MAIN_B, IMG, IMG, 3), dtype=np.uint8)

    # the main path: counts from 0 just before, read just after
    for k in att.LAUNCHES:
        att.LAUNCHES[k] = 0
    s128 = serve128(u8)
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    for k in att.LAUNCHES:
        att.LAUNCHES[k] = 0
    s32 = serve32(u8[:32])
    torch.cuda.synchronize()
    launches32 = dict(att.LAUNCHES)
    want = {k: DEPTH for k in KERNELS}
    if launches != want or launches32 != want:
        raise AssertionError(f"kernel launches per forward {launches} "
                             f"(B=128), {launches32} (B=32); want {want}")

    with plain_blocks():
        plain = serve128(u8)
    with torch.inference_mode(), exact_f32_matmul():
        model.to(dev)
        x = normalize(to_float(torch.from_numpy(u8).to(dev)))
        logits = torch.cat([model(x[i:i + 32]) for i in range(0, MAIN_B, 32)])
        ref = torch.sigmoid(logits[:, 1] - logits[:, 0])
        model.cpu()
    err_plain = (s128 - plain).abs().max().item()
    err128 = (s128 - ref).abs().max().item()
    err32 = (s32 - ref[:32]).abs().max().item()
    mean_plain = (s128 - plain).abs().mean().item()
    mean128 = (s128 - ref).abs().mean().item()
    ok = (s128.shape == (MAIN_B,) and s32.shape == (32,)
          and bool(torch.isfinite(s128).all())
          and bool(((s128 >= 0) & (s128 <= 1)).all())
          and max(err_plain, err128, err32) <= SCORE_TOL
          and max(mean_plain, mean128) <= SCORE_MEAN_TOL)
    emit({"phase": "slice", "launches_b128": launches,
          "launches_b32": launches32,
          "max_abs_err_b128_vs_plain": err_plain,
          "mean_abs_err_b128_vs_plain": mean_plain,
          "bit_equal_vs_plain": (s128 == plain).float().mean().item(),
          "max_abs_err_b128_vs_f32": err128,
          "mean_abs_err_b128_vs_f32": mean128,
          "plain_max_abs_err_vs_f32": (plain - ref).abs().max().item(),
          "max_abs_err_b32_vs_f32": err32,
          "b32_vs_b128_max_abs_diff":
              (s32 - s128[:32]).abs().max().item(),
          "score_min": s128.min().item(), "score_max": s128.max().item(),
          "score_std": s128.std().item(), "tol": SCORE_TOL,
          "mean_tol": SCORE_MEAN_TOL, "ok": ok})
    if not ok:
        raise AssertionError(
            f"served scores disagree: max {err_plain} (mean {mean_plain}) "
            f"vs the plain path, max {err128} / {err32} (mean {mean128}) "
            f"vs the f32 module; tol {SCORE_TOL}, mean {SCORE_MEAN_TOL}")
    return model, serve128, u8, launches


def phase_serving(model, serve128):
    rng = np.random.default_rng(SEED + 2)
    n = 300
    imgs = rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    programs, img_size, metas = build_programs_live(
        model, shapes=(32, 128), img_size=IMG)
    batcher = MicroBatcher(programs, img_size=img_size, max_wait_ms=5.0)
    try:
        batcher.warmup()
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(
                lambda i: batcher.submit(imgs[i]).result(timeout=300), i)
                for i in range(n)]
            answers = [f.result() for f in futs]
        stats = batcher.stats()
    finally:
        batcher.close()
    direct = []
    for i in range(0, n, MAIN_B):
        chunk = np.zeros((MAIN_B, IMG, IMG, 3), np.uint8)
        part = imgs[i:i + MAIN_B]
        chunk[:len(part)] = part
        direct.append(serve128(chunk)[:len(part)].cpu().numpy())
    direct = np.concatenate(direct)
    prob1 = np.array([a["prob1"] for a in answers], np.float32)
    err = float(np.abs(prob1 - direct).max())
    ok = len(answers) == n and err <= SERVE_TOL and all(
        a["pred"] == int(a["prob1"] > 0.5) for a in answers)
    emit({"phase": "serving", "requests": n, "answered": len(answers),
          "max_abs_err_vs_direct": err,
          "exactly_equal": int((prob1 == direct).sum()), "tol": SERVE_TOL,
          "batches": stats["batches"], "avg_batch": stats["avg_batch"],
          "padded_rows": stats["padded_rows"], "metas_shapes": {
              str(k): v for k, v in metas[0]["shapes"].items()},
          "ok": ok})
    if not ok:
        raise AssertionError(f"micro-batched scores disagree with the "
                             f"direct ones: {err} > {SERVE_TOL}")


def phase_times(dev, model, serve128, u8, main_err, launches) -> list:
    rng = np.random.default_rng(SEED + 3)
    a_in, m_in = block_inputs(rng, MAIN_B, TP, D, HIDDEN, dev)
    timed = {
        "attention_block": (
            lambda: att.fused_attention_block_padded(
                **a_in, num_heads=HEADS, valid_len=T),
            lambda: att.fused_attention_block_padded_plain(
                **a_in, num_heads=HEADS, valid_len=T),
            attention_work(MAIN_B, TP, D, HEADS)),
        "mlp_block": (
            lambda: att.fused_mlp_block(**m_in),
            lambda: att.fused_mlp_block_plain(**m_in),
            mlp_work(MAIN_B * TP, D, HIDDEN)),
    }
    rows = []
    for name, (kernel, plain, (flops, nbytes)) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, per_window=3)
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append({"name": name, "route": "cuda", **KERNELS[name],
                     "launches": launches[name],
                     "max_abs_err": main_err[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    del a_in, m_in

    batch = torch.from_numpy(u8).to(dev)
    e2e_ms = time_ms(lambda: serve128(batch), windows=3, per_window=5)
    # the stem and the head alone, on the same weights and batch
    weights, _raw, kw = fastserve.serving_program(model, mode="fastserve")
    with torch.inference_mode():
        stem_ms = time_ms(lambda: fastserve.embed_patches(
            weights["vit"], batch, dtype=kw["dtype"], patch_size=PATCH))
        stream = torch.zeros((MAIN_B, TP, D), dtype=kw["dtype"], device=dev)
        head_ms = time_ms(lambda: fastserve._cls_head_scores(
            weights, stream, norm_eps=kw["norm_eps"], dtype=kw["dtype"]))
    kernel_ms = DEPTH * sum(r["ms"] for r in rows)
    emit({"phase": "times", "batch": MAIN_B, "e2e_ms": e2e_ms,
          "img_per_s": MAIN_B / (e2e_ms / 1e3),
          "kernels_ms_per_forward": kernel_ms, "stem_ms": stem_ms,
          "head_ms": head_ms,
          "bound_ms_per_forward": DEPTH * sum(r["bound_ms"] for r in rows),
          "kernels": {r["name"]: {k: r[k] for k in
                                  ("ms", "plain_ms", "bound_ms")}
                      for r in rows}})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    main_err = phase_kernels(dev)
    model, serve128, u8, launches = phase_slice(dev)
    phase_serving(model, serve128)
    rows = phase_times(dev, model, serve128, u8, main_err, launches)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
