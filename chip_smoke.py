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
            magnitude (of each output, and of each of dq, dk, dv), since
            the two sum in different f32 orders and a flipped rounding of
            an intermediate (qkv, softmax weights, dl, GELU output) moves
            the output by about one ulp.  The LN backward's f32 parameter
            sums must also agree bit for bit between two runs.
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
   kernels  (again) the whole-encoder kernels against their plain
            versions: at depth 1 and ViT-B width, kernel 10 fold-ends
            (B = 1) and encoder-only (B = 1, 2), kernel 11 at chunks of
            1-4 (the last item zero, as a pad item), within 2 bf16 ulps
            of the largest output magnitude as above; a ragged shape
            (Tp 40, valid_len 33, D 64, 4 heads, hidden 256) at depth 2,
            within 2 ulps per layer; and at the full 12 layers on phase
            4's weights, where per-layer ulps compound: scores within
            phase 4's bounds, streams within them relative to the
            stream's max and mean magnitude.
6. slice_small  make_serving_fn on phase 4's model at B = 1 (auto ->
            lowlat, fold-ends) and B = 2, 4, 8, 16 (auto -> batch_grid),
            64 images at each B: every forward launches kernel 10 exactly
            once at B = 1, kernel 11 ceil(B/2) times otherwise, kernels
            1-2 never; the 64 scores held against the same regime with
            its kernel swapped for its plain version and against the f32
            module, within phase 4's bounds (the mean over the 64).
7. http     the HTTP front over build_programs_live's default shapes (1,
            2, 4, 8, 16) on 127.0.0.1: 64 distinct raw frames from 8
            threads, then loadgen.run_load in raw mode, 200 requests at 1
            client and 200 at 8; every answer within 1e-3 of the direct
            make_serving_fn score of its frame at the dispatch size that
            served it (at 1 client: B = 1).  Client p50/p99, img/s and
            the server's batch fill.
8. train    one bf16 training step of a ViT-B/16 ViTAntiSpoof (erf GELU,
            random weights, normalized f32 images and labels from the
            seed) at B = 128 through models/fasttrain.py.  Step 0 with
            dropout off three ways: on the kernels, with the three
            training kernels swapped for their plain versions, and as f32
            autograd of the port's module (TF32 off); each parameter
            leaf's gradient must be within 0.1 relative L2 of f32 (the JAX
            package's own bf16 spread is up to 8.8e-2).  Then 5
            make_train_step steps with dropout 0.1 on one batch (AdamW
            with the default peak LR 3e-4 reached by the schedule's
            linear warmup over 100 steps): each step
            launches the training attention block and the attention
            backward exactly 12 times, the LN backward 24 times and the
            serving kernels never; loss and grad_norm are finite and the
            loss falls.  A make_eval_step afterwards launches the serving
            attention block 12 times and scores within [0, 1].
9. times    CUDA-event medians after warm-up: each kernel beside its
            plain version, its bound and the PyTorch call that computes
            the same function where there is one, at the main path's
            shapes; the stem and head; end-to-end img/s of scoring and of
            the training step at B = 128; kernel 10 at B = 1 and kernel
            11 per 2-item chunk, each with a per-phase breakdown from
            its barrier timestamps (ops/lowlat.py ``trace``); the B = 1
            forward (and a profile of it), the batch-grid forward at
            B = 2, 4, 8, 16 and, as the yardstick of the regime table,
            the fastserve forward at B = 1-16.

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
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vit_spoof_detection_pda_tpu_torch.device import exact_f32_matmul
from vit_spoof_detection_pda_tpu_torch.models import fastserve
from vit_spoof_detection_pda_tpu_torch.models import fasttrain
from vit_spoof_detection_pda_tpu_torch.models.convert import (
    antispoof_from_torch, load_jax_params)
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof
from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.ops import attention as att
from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd
from vit_spoof_detection_pda_tpu_torch.ops import lowlat as low
from vit_spoof_detection_pda_tpu_torch.ops.image import normalize, to_float
from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn
from vit_spoof_detection_pda_tpu_torch.serve import (
    MicroBatcher, build_programs_live, make_server_from_programs, run_load)
from vit_spoof_detection_pda_tpu_torch.serve.loadgen import sample_frame
from vit_spoof_detection_pda_tpu_torch.train.schedule import make_lr_schedule
from vit_spoof_detection_pda_tpu_torch.train.state import (
    create_train_state, make_optimizer, tree_flatten)
from vit_spoof_detection_pda_tpu_torch.train.step import (make_eval_step,
                                                          make_train_step)

SEED = 0
IMG, PATCH, D, HEADS, DEPTH, HIDDEN, HEAD_HIDDEN = 224, 16, 768, 12, 12, 3072, 512
T = (IMG // PATCH) ** 2 + 1          # 197 tokens
TP = att._round_up(T, 8)             # 200-row padded stream
MAIN_B = 128
SCORE_TOL = 5e-2                     # max |diff| of P(live), see phase 4
SCORE_MEAN_TOL = 1e-2                # mean |diff| of P(live)
SERVE_TOL = 1e-3
SMALL_B = (1, 2, 4, 8, 16)           # the JAX server's default shapes
SMALL_IMAGES = 64                    # scored at each of them
HTTP_REQUESTS = 200
GRAD_REL_TOL = 0.1                   # per-leaf relative L2, bf16 vs f32
TRAIN_STEPS = 5
PEAK_BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores

KERNELS = {
    "attention_block": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/attention_block.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/attention.py:412"),
    "mlp_block": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/mlp_block.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/attention.py:532"),
    "attention_block_train": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/attention_block_train.cu",
        replaces="vit_spoof_detection_pda_tpu/models/fasttrain.py:70"),
    "attention_qkv_bwd": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/attention_qkv_bwd.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/attention.py:199"),
    "ln_res_bwd": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/ln_res_bwd.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/ln_bwd.py:45"),
    "lowlat_encoder": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/lowlat_encoder.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/lowlat.py:94"),
    "lowlat_batchgrid": dict(
        source="vit_spoof_detection_pda_tpu_torch/csrc/lowlat_batchgrid.cu",
        replaces="vit_spoof_detection_pda_tpu/ops/lowlat.py:241"),
}
SERVING_KERNELS = ("attention_block", "mlp_block")
TRAIN_KERNELS = ("attention_block_train", "attention_qkv_bwd", "ln_res_bwd")
LOWLAT_KERNELS = ("lowlat_encoder", "lowlat_batchgrid")


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


@contextlib.contextmanager
def plain_training_kernels():
    """Run the training forward's three kernels on their plain versions
    (the card's bf16 reference of the whole step); restores the kernels."""
    names = ("attention_block_train_padded", "attention_qkv_bwd",
             "ln_residual_bwd")
    saved = [getattr(fasttrain, n) for n in names]
    fasttrain.attention_block_train_padded = (
        att.attention_block_train_padded_plain)
    fasttrain.attention_qkv_bwd = att.attention_qkv_bwd_plain
    fasttrain.ln_residual_bwd = ln_bwd.ln_residual_bwd_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(fasttrain, n, f)


@contextlib.contextmanager
def plain_lowlat():
    """Run the small-batch regimes' kernels on their plain versions (the
    serving functions look them up in ops/lowlat.py at each call)."""
    names = ("forward_lowlat_e2e", "encoder_forward_lowlat",
             "encoder_forward_lowlat_batchgrid")
    saved = [getattr(low, n) for n in names]
    for n in names:
        setattr(low, n, getattr(low, n + "_plain"))
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(low, n, f)


def reset_launches():
    for k in att.LAUNCHES:
        att.LAUNCHES[k] = 0


def bf16_tol(want: torch.Tensor, ulps: int = 2) -> float:
    """``ulps`` bf16 ulps at the largest magnitude of ``want``."""
    amax = want.float().abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(amax)) - 7) if amax else 0.0


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


def train_inputs(rng, b, tp, valid, d, dev):
    """Operands of the attention backward (qkv, g) and of the LN backward
    (xh, inv, dxn, g, lns), numpy-seeded; the cotangents are zero on the
    pad rows past ``valid``, as the training path gives them."""
    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, torch.bfloat16)

    g = bf(b, tp, d)
    g[:, valid:] = 0
    bwd = dict(qkv=bf(b, tp, 3 * d), g=g)
    dxn, g2 = bf(b, tp, d), bf(b, tp, d)
    dxn[:, valid:] = 0
    g2[:, valid:] = 0
    inv = rng.uniform(0.5, 2.0, (b, tp, 1)).astype(np.float32)
    lns = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ln = dict(xh=bf(b, tp, d), inv=torch.from_numpy(inv).to(dev), dxn=dxn,
              g=g2, lns=torch.from_numpy(lns).to(dev))
    return bwd, ln


def random_params(rng, *, d=D, depth=DEPTH, hidden=HIDDEN) -> dict:
    """ViTAntiSpoof parameters in the JAX layout (ViT-B/16 by default):
    encoder matrices N(0, 0.02), LN scales near 1, head sized so scores
    spread."""
    def n(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(i, o, std):
        return {"kernel": n(i, o, std=std), "bias": n(o, std=0.02)}

    def ln(dim):
        return {"scale": 1.0 + n(dim, std=0.1), "bias": n(dim, std=0.05)}

    vit = {"patch_embed": dense(PATCH * PATCH * 3, d, 0.02),
           "cls_token": n(1, 1, d, std=0.02),
           "pos_embed": n(1, T, d, std=0.02), "norm": ln(d)}
    for i in range(depth):
        vit[f"block{i}"] = {
            "norm1": ln(d),
            "attn": {"qkv": dense(d, 3 * d, 0.02), "proj": dense(d, d, 0.02)},
            "norm2": ln(d),
            "mlp": {"fc1": dense(d, hidden, 0.02),
                    "fc2": dense(hidden, d, 0.02)}}
    head = {"norm": ln(d), "fc1": dense(d, HEAD_HIDDEN, d ** -0.5),
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


def clocks_during(fn, seconds: float = 1.0) -> dict:
    """SM clock, its maximum and the power draw, sampled by nvidia-smi
    every 100 ms while ``fn`` runs back to back for ``seconds``; the
    sampler is stopped before this returns."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = []
    for ln in out.splitlines():
        try:
            rows.append([float(v) for v in ln.split(",")])
        except ValueError:                       # a "[N/A]" field
            continue
    rows = [r for r in rows if len(r) == 3]
    if not rows:
        return {"samples": 0}
    sm, mx, pw = (sorted(col) for col in zip(*rows))
    return {"samples": len(rows), "sm_mhz_median": sm[len(sm) // 2],
            "sm_mhz_min": sm[0], "sm_mhz_max_allowed": mx[-1],
            "power_w_median": pw[len(pw) // 2]}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(b, tp, d, heads):
    flops = 2 * b * tp * d * 4 * d + 4 * b * heads * tp * tp * (d // heads)
    nbytes = 2 * b * tp * d * 2 + (3 * d * d + d * d) * 2 + 6 * d * 4
    return flops, nbytes


def attention_train_work(b, tp, d, heads):
    """Kernel 1's products; x in, out, qkv, attn and xhat out (bf16), inv
    out (f32), the weights and vectors in."""
    flops, _ = attention_work(b, tp, d, heads)
    nbytes = (7 * b * tp * d * 2 + b * tp * 4 + (3 * d * d + d * d) * 2
              + 6 * d * 4)
    return flops, nbytes


def attention_bwd_work(b, tp, d, heads):
    """The TPU kernel's five [Tp, Tp] x Dh products per head (scores, dv,
    dw, dq, dk); qkv and g in, dqkv out (bf16)."""
    flops = 5 * 2 * b * heads * tp * tp * (d // heads)
    nbytes = b * tp * (3 * d + d + 3 * d) * 2
    return flops, nbytes


def ln_bwd_work(rows, d):
    """About 10 f32 operations per element (outside the tensor cores);
    xh, dxn and g in and dx out (bf16), inv in, lns in, two sums out."""
    return 10 * rows * d, rows * d * 2 * 4 + rows * 4 + 3 * d * 4


def lowlat_work(b, depth, *, hh=0):
    """A whole-encoder launch over B items of Tp rows: per layer the qkv,
    proj, fc1 and fc2 products (12 D^2 a row) and the attention's two
    [Tp, Tp] x Dh products per head; with fold-ends (``hh``) the
    patch-embed over the Tp rows and the head's two products."""
    flops = depth * (2 * b * TP * D * 12 * D + 4 * b * TP * TP * D)
    if hh:
        flops += 2 * b * TP * D * D + 2 * b * D * hh + 4 * b * hh
    return flops


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def _kernel_parts(a_in, m_in, bwd, ln, heads, valid):
    """Per kernel, ``[(part, kernel output, plain output)]``; the LN
    backward also returns a second run's parameter sums."""
    out = {}
    got = att.attention_block_train_padded(**a_in, num_heads=heads,
                                           valid_len=valid)
    want = att.attention_block_train_padded_plain(**a_in, num_heads=heads,
                                                  valid_len=valid)
    out["attention_block_train"] = list(zip(
        ("out", "qkv", "attn", "xhat", "inv"), got, want))
    d = bwd["g"].shape[-1]
    got = att.attention_qkv_bwd(**bwd, num_heads=heads, valid_len=valid)
    want = att.attention_qkv_bwd_plain(**bwd, num_heads=heads,
                                       valid_len=valid)
    out["attention_qkv_bwd"] = [
        (part, got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d])
        for i, part in enumerate(("dq", "dk", "dv"))]
    got = ln_bwd.ln_residual_bwd(**ln)
    again = ln_bwd.ln_residual_bwd(**ln)
    want = ln_bwd.ln_residual_bwd_plain(**ln)
    out["ln_res_bwd"] = list(zip(("dx", "dscale", "dbias"), got, want))
    out["attention_block"] = [("out", att.fused_attention_block_padded(
        **a_in, num_heads=heads, valid_len=valid),
        att.fused_attention_block_padded_plain(
            **a_in, num_heads=heads, valid_len=valid))]
    out["mlp_block"] = [("out", att.fused_mlp_block(**m_in),
                         att.fused_mlp_block_plain(**m_in))]
    sums_repeat = (torch.equal(got[1], again[1])
                   and torch.equal(got[2], again[2]))
    return out, sums_repeat


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
        bwd, ln = train_inputs(rng, b, tp, valid, d, dev)
        parts, sums_repeat = _kernel_parts(a_in, m_in, bwd, ln, heads, valid)
        torch.cuda.synchronize()
        for name in parts:
            errs, ok = {}, True
            for part, g, w in parts[name]:
                g, w = g.float(), w.float()
                err = (g - w).abs().max().item()
                tol = bf16_tol(w)
                errs[part] = {"max_abs_err": err, "tol": tol,
                              "mean_abs_err": (g - w).abs().mean().item()}
                ok = ok and bool(torch.isfinite(g).all()) and err <= tol
            if name == "ln_res_bwd":
                ok = ok and sums_repeat
            emit({"phase": "kernels", "case": label, "kernel": name,
                  "shape": list(parts[name][0][1].shape), "valid_len": valid,
                  "parts": errs, "ok": ok,
                  **({"sums_bit_equal_across_runs": sums_repeat}
                     if name == "ln_res_bwd" else {})})
            if not ok:
                raise AssertionError(
                    f"{name} disagrees with its plain version on {label}: "
                    f"{errs}")
            if label.startswith("main_path"):
                main_err[name] = max(e["max_abs_err"] for e in errs.values())
        del a_in, m_in, bwd, ln, parts
    return main_err


def phase_slice(dev):
    rng = np.random.default_rng(SEED + 1)
    params = random_params(rng)
    model = load_jax_params(ViTAntiSpoof(gelu="tanh").eval(), params)
    serve128 = fastserve.make_serving_fn(model, batch_size=MAIN_B)
    serve32 = fastserve.make_serving_fn(model, batch_size=32)
    u8 = rng.integers(0, 256, (MAIN_B, IMG, IMG, 3), dtype=np.uint8)

    # the main path: counts from 0 just before, read just after
    reset_launches()
    s128 = serve128(u8)
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    reset_launches()
    s32 = serve32(u8[:32])
    torch.cuda.synchronize()
    launches32 = dict(att.LAUNCHES)
    want = {k: DEPTH if k in SERVING_KERNELS else 0 for k in att.LAUNCHES}
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


def phase_kernels_lowlat(dev, model):
    """Kernels 10 and 11 against their plain versions; returns the errors
    at the main path's shapes (12 layers) and the two regimes' prepared
    packs of phase 4's model."""
    rng = np.random.default_rng(SEED + 6)
    bf = torch.bfloat16
    main_err = {}

    def check(case, name, got, want, *, ulps=2, tol=None, mean_tol=None,
              **extra):
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        err, mean = diff.max().item(), diff.mean().item()
        tol = bf16_tol(w, ulps) if tol is None else tol
        ok = (bool(torch.isfinite(g).all()) and err <= tol
              and (mean_tol is None or mean <= mean_tol))
        emit({"phase": "kernels", "case": case, "kernel": name,
              "shape": list(g.shape), "max_abs_err": err,
              "mean_abs_err": mean, "tol": tol, "mean_tol": mean_tol,
              "ok": ok, **extra})
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {case}: {err} (tol {tol}), mean "
                                 f"{mean} (tol {mean_tol})")
        return err

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, bf)

    # depth 1 at ViT-B width: 2 ulps, as phase 3 holds kernels 1-2
    tree = random_params(rng, depth=1)["params"]
    w1, s1 = low.pack_encoder_weights(tree["vit"], depth=1, device=dev)
    bw1, bs1 = low.pack_encoder_weights_batchgrid(tree["vit"], depth=1,
                                                  device=dev)
    ends = low.pack_end_weights(tree, device=dev)
    kw = dict(num_heads=HEADS, valid_len=T)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, IMG, IMG, 3),
                                       dtype=np.uint8)).to(dev)
    xp = fastserve.patch_rows(u8[:1], patch_size=PATCH, tp=TP, dtype=bf)
    check("vit_b_depth1_b1_fold_ends", "lowlat_encoder",
          low.forward_lowlat_e2e(xp, w1, s1, *ends, **kw),
          low.forward_lowlat_e2e_plain(xp, w1, s1, *ends, **kw))
    for b in (1, 2):
        x = normal(b, TP, D)
        check(f"vit_b_depth1_b{b}", "lowlat_encoder",
              low.encoder_forward_lowlat(x, w1, s1, **kw),
              low.encoder_forward_lowlat_plain(x, w1, s1, **kw))
    for c in (1, 2, 3, 4):
        x = normal(c, TP, D)
        if c > 1:
            x[-1] = 0                                # a zero pad item
        check(f"vit_b_depth1_chunk{c}", "lowlat_batchgrid",
              low.encoder_forward_lowlat_batchgrid(x, bw1, bs1, **kw),
              low.encoder_forward_lowlat_batchgrid_plain(x, bw1, bs1, **kw))
    del tree, w1, s1, bw1, bs1, ends

    # ragged, depth 2: 2 ulps per layer
    tree = random_params(rng, d=64, depth=2, hidden=256)["params"]
    wr, sr = low.pack_encoder_weights(tree["vit"], depth=2, device=dev)
    bwr, bsr = low.pack_encoder_weights_batchgrid(tree["vit"], depth=2,
                                                  device=dev)
    kr = dict(num_heads=4, valid_len=33)
    x = normal(2, 40, 64)
    check("ragged_depth2_b2", "lowlat_encoder",
          low.encoder_forward_lowlat(x, wr, sr, **kr),
          low.encoder_forward_lowlat_plain(x, wr, sr, **kr), ulps=4)
    x = normal(3, 40, 64)
    x[-1] = 0
    check("ragged_depth2_chunk3", "lowlat_batchgrid",
          low.encoder_forward_lowlat_batchgrid(x, bwr, bsr, **kr),
          low.encoder_forward_lowlat_batchgrid_plain(x, bwr, bsr, **kr),
          ulps=4)

    # 12 layers, phase 4's folded weights in the main path's packs: the
    # scores within phase 4's bounds, the streams within them relative
    # to their magnitude (per-layer ulps compound through the layers)
    progs = {mode: fastserve.serving_program(model, mode=mode)
             for mode in ("lowlat", "batch_grid")}
    prep, bprep = progs["lowlat"][0], progs["batch_grid"][0]
    ends = (prep["end_w"], prep["end_s"], prep["aux"])
    xp = fastserve.patch_rows(u8[:1], patch_size=PATCH, tp=TP, dtype=bf)
    got = low.forward_lowlat_e2e(xp, prep["packed_w"], prep["packed_s"],
                                 *ends, **kw)
    want = low.forward_lowlat_e2e_plain(xp, prep["packed_w"],
                                        prep["packed_s"], *ends, **kw)
    main_err["lowlat_encoder"] = (got - want).abs().max().item()
    check("vit_b_depth12_b1_fold_ends_score", "lowlat_encoder",
          torch.sigmoid(got[:, 1] - got[:, 0]),
          torch.sigmoid(want[:, 1] - want[:, 0]), tol=SCORE_TOL,
          logits_max_abs_err=main_err["lowlat_encoder"])
    stream, _t = fastserve.padded_stream(prep["params"]["vit"], u8,
                                         dtype=bf, patch_size=PATCH)

    def rel(want):
        w = want.float().abs()
        return dict(tol=SCORE_TOL * w.max().item(),
                    mean_tol=SCORE_MEAN_TOL * w.mean().item())

    want = low.encoder_forward_lowlat_plain(
        stream[:1], prep["packed_w"], prep["packed_s"], **kw)
    check("vit_b_depth12_b1", "lowlat_encoder",
          low.encoder_forward_lowlat(stream[:1], prep["packed_w"],
                                     prep["packed_s"], **kw), want,
          **rel(want))
    want = low.encoder_forward_lowlat_batchgrid_plain(
        stream, bprep["bg_w"], bprep["bg_s"], **kw)
    main_err["lowlat_batchgrid"] = check(
        "vit_b_depth12_chunk2", "lowlat_batchgrid",
        low.encoder_forward_lowlat_batchgrid(stream, bprep["bg_w"],
                                             bprep["bg_s"], **kw), want,
        **rel(want))
    return main_err, progs


def _small_launches_want(b: int) -> dict:
    want = {k: 0 for k in att.LAUNCHES}
    if b == 1:
        want["lowlat_encoder"] = 1
    else:
        want["lowlat_batchgrid"] = -(-b // 2)
    return want


def phase_slice_small(dev, model):
    """make_serving_fn at the JAX server's default shapes, each B scoring
    SMALL_IMAGES images in SMALL_IMAGES / B forwards (phase 4's mean bound
    needs a population of scores); returns the serving functions and the
    launches of the run."""
    rng = np.random.default_rng(SEED + 5)
    u8 = rng.integers(0, 256, (SMALL_IMAGES, IMG, IMG, 3), dtype=np.uint8)
    fns = {b: fastserve.make_serving_fn(model, batch_size=b)
           for b in SMALL_B}

    def run(fn, b):
        return torch.cat([fn(u8[i:i + b]) for i in range(0, SMALL_IMAGES, b)])

    # the main path: counts from 0 just before, read just after; every
    # forward's own launches are checked on the way
    reset_launches()
    got, bad_forwards = {}, []
    for b in SMALL_B:
        outs = []
        for i in range(0, SMALL_IMAGES, b):
            before = dict(att.LAUNCHES)
            outs.append(fns[b](u8[i:i + b]))
            torch.cuda.synchronize()
            delta = {k: att.LAUNCHES[k] - before[k] for k in before}
            if delta != _small_launches_want(b):
                bad_forwards.append((b, i, delta))
        got[b] = torch.cat(outs)
    launches = dict(att.LAUNCHES)

    with plain_lowlat():
        plain = {b: run(fns[b], b) for b in SMALL_B}
    with torch.inference_mode(), exact_f32_matmul():
        model.to(dev)
        x = normalize(to_float(torch.from_numpy(u8).to(dev)))
        logits = torch.cat([model(x[i:i + 16])
                            for i in range(0, SMALL_IMAGES, 16)])
        ref = torch.sigmoid(logits[:, 1] - logits[:, 0])
        model.cpu()
    out, ok = {}, not bad_forwards
    for b in SMALL_B:
        g, p = got[b], plain[b]
        e = {"regime": fastserve.auto_serving_mode(b),
             "forwards": SMALL_IMAGES // b,
             "launches_per_forward": {k: v for k, v in
                                      _small_launches_want(b).items() if v},
             "max_abs_err_vs_plain": (g - p).abs().max().item(),
             "mean_abs_err_vs_plain": (g - p).abs().mean().item(),
             "max_abs_err_vs_f32": (g - ref).abs().max().item(),
             "mean_abs_err_vs_f32": (g - ref).abs().mean().item(),
             "plain_max_abs_err_vs_f32": (p - ref).abs().max().item(),
             "plain_mean_abs_err_vs_f32": (p - ref).abs().mean().item()}
        ok = ok and (
            tuple(g.shape) == (SMALL_IMAGES,)
            and bool(torch.isfinite(g).all())
            and bool(((g >= 0) & (g <= 1)).all())
            and max(e["max_abs_err_vs_plain"], e["max_abs_err_vs_f32"])
            <= SCORE_TOL
            and max(e["mean_abs_err_vs_plain"], e["mean_abs_err_vs_f32"])
            <= SCORE_MEAN_TOL)
        out[str(b)] = e
    emit({"phase": "slice_small", "images": SMALL_IMAGES, "per_batch": out,
          "launches": launches, "bad_forwards": bad_forwards[:5],
          "lowlat_vs_batch_grid_max_abs_diff":
              (got[1] - got[16]).abs().max().item(),
          "score_min": got[16].min().item(),
          "score_max": got[16].max().item(),
          "score_std": got[16].std().item(), "tol": SCORE_TOL,
          "mean_tol": SCORE_MEAN_TOL, "ok": ok})
    if not ok:
        raise AssertionError(f"small-batch serving failed: {out}; "
                             f"forwards off their launch counts: "
                             f"{bad_forwards[:5]}")
    return fns, launches


def phase_http(model, fns):
    """The HTTP front on the default shapes; returns its summary."""
    rng = np.random.default_rng(SEED + 7)
    programs, img_size, metas = build_programs_live(model, img_size=IMG)
    server = make_server_from_programs(programs, img_size, metas,
                                       host="127.0.0.1", port=0,
                                       max_wait_ms=2.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    imgs = rng.integers(0, 256, (64, IMG, IMG, 3), dtype=np.uint8)

    def score(i):
        req = urllib.request.Request(
            url + "/score", data=imgs[i].tobytes(), method="POST",
            headers={"Content-Type": "application/x-pad-raw"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())["prob_live"]

    try:
        server.batcher.warmup()
        with ThreadPoolExecutor(8) as pool:
            distinct = np.array(list(pool.map(score, range(len(imgs)))),
                                np.float32)
        runs = {}
        for clients in (1, 8):
            answers = []
            runs[clients] = (run_load(url, mode="raw", clients=clients,
                                      requests=HTTP_REQUESTS, img_size=IMG,
                                      warmup=16, answers=answers), answers)
        stats = server.batcher.stats()
    finally:
        server.shutdown_clean()
        thread.join(timeout=60)

    def direct(batch):
        """``{B: each frame's score in a dispatch of B frames}`` for the
        server's shapes.  The kernels give an item the same bits whatever
        its co-riders (checked in the kernels phase); the stem's cuBLAS
        f32 GEMM may not across B (its algorithm follows M = 196 B), so
        an answer is held against the dispatch size that served it."""
        out = {}
        for b in SMALL_B:
            rows = np.resize(batch, (-(-len(batch) // b) * b,)
                             + batch.shape[1:])       # repeated cyclically
            out[b] = np.concatenate([fns[b](rows[i:i + b]).cpu().numpy()
                                     for i in range(0, len(rows), b)])
            out[b] = out[b][:len(batch)]
        return out

    def nearest(answers, scores):
        """Per answer, the distance to the nearest direct score, and the
        dispatch size it matches."""
        dist = np.stack([np.abs(answers - scores[b]) for b in SMALL_B])
        return dist.min(0), np.array(SMALL_B)[dist.argmin(0)]

    want = direct(imgs)
    err, sizes = nearest(distinct, want)
    f_want = direct(sample_frame(IMG)[None])
    out = {"phase": "http", "shapes": {str(k): v for k, v in
                                       metas[0]["shapes"].items()},
           "distinct_requests": len(imgs),
           "distinct_max_abs_err_vs_direct": float(err.max()),
           "distinct_served_at": {str(b): int((sizes == b).sum())
                                  for b in SMALL_B},
           "direct_spread_across_b": float(max(
               np.abs(want[b] - want[1]).max() for b in SMALL_B)),
           "tol": SERVE_TOL}
    ok = err.max() <= SERVE_TOL and not thread.is_alive()
    for clients, (load, answers) in runs.items():
        a = np.array([x["prob_live"] for x in answers], np.float32)
        e, _ = nearest(a, {b: np.full_like(a, f_want[b][0])
                           for b in SMALL_B})
        e_lone = np.abs(a - f_want[1][0])
        # one client: every request is dispatched alone (B = 1)
        worst = float((e_lone if clients == 1 else e).max()) if a.size else 1.0
        ok = ok and (load["errors"] == 0 and len(a) == HTTP_REQUESTS
                     and worst <= SERVE_TOL)
        out[f"clients{clients}"] = {
            "requests": load["requests"], "errors": load["errors"],
            "img_per_s": load["img_per_s"], "latency_ms": load["latency_ms"],
            "avg_batch_fill": load.get("avg_batch_fill"),
            "max_abs_err_vs_direct": worst}
    out.update(server_batches=stats["batches"],
               server_avg_batch=stats["avg_batch"],
               server_padded_rows=stats["padded_rows"],
               server_latency_ms=stats.get("latency_ms"), ok=ok)
    emit(out)
    if not ok:
        raise AssertionError(f"HTTP serving failed: {out}")
    return out


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_train(dev):
    """Step 0 three ways, then TRAIN_STEPS make_train_step steps and one
    eval step; returns what phase times needs."""
    rng = np.random.default_rng(SEED + 4)
    params = random_params(rng)
    u8 = rng.integers(0, 256, (MAIN_B, IMG, IMG, 3), dtype=np.uint8)
    images = normalize(to_float(torch.from_numpy(u8).to(dev)))
    labels = torch.from_numpy(rng.integers(0, 2, MAIN_B)).to(dev)
    model = load_jax_params(ViTAntiSpoof(
        patch_size=PATCH, embed_dim=D, depth=DEPTH, num_heads=HEADS,
        hidden=HEAD_HIDDEN, img_size=IMG, gelu="erf", dropout=0.0), params)
    loss_fn = make_loss_fn("focal")
    apply_fn = fasttrain.make_apply(model)               # bf16

    def step0():
        """Loss and gradient leaves of the kernel path on fresh params."""
        state = create_train_state(model, make_optimizer(3e-4), SEED,
                                   variables=params, apply_fn=apply_fn,
                                   device=dev)
        leaves, paths = tree_flatten(state.params)
        loss = loss_fn(apply_fn({"params": state.params}, images,
                                train=True), labels)
        return loss.item(), dict(zip(paths, torch.autograd.grad(loss,
                                                                leaves)))

    loss_k, grads_k = step0()
    with plain_training_kernels():
        loss_p, grads_p = step0()
    with exact_f32_matmul():                              # f32 reference
        model.to(dev).eval()
        loss_f = loss_fn(model(images), labels)
        loss_f.backward()
        ref = antispoof_from_torch({k: p.grad for k, p in
                                    model.named_parameters()})["params"]
        model.zero_grad(set_to_none=True)
        model.cpu()
    ref_leaves, ref_paths = tree_flatten(ref)
    gap_k, gap_p, gap_kp = {}, {}, {}
    for path, r in zip(ref_paths, ref_leaves):
        r = torch.from_numpy(r).to(dev)
        name = "/".join(path)
        gap_k[name] = _rel_l2(grads_k[path], r)
        gap_p[name] = _rel_l2(grads_p[path], r)
        gap_kp[name] = _rel_l2(grads_k[path], grads_p[path])
    del grads_k, grads_p, ref, ref_leaves
    worst = max(gap_k, key=gap_k.get)
    ok0 = (all(math.isfinite(v) for v in (loss_k, loss_p, loss_f.item()))
           and max(gap_k.values()) <= GRAD_REL_TOL)
    emit({"phase": "train_step0", "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_f32": loss_f.item(),
          "loss_gap_kernels_vs_f32": abs(loss_k - loss_f.item()),
          "loss_gap_kernels_vs_plain": abs(loss_k - loss_p),
          "max_leaf_rel_l2_kernels_vs_f32": gap_k[worst], "worst_leaf": worst,
          "max_leaf_rel_l2_plain_vs_f32": max(gap_p.values()),
          "max_leaf_rel_l2_kernels_vs_plain": max(gap_kp.values()),
          "tol": GRAD_REL_TOL, "leaves": len(gap_k),
          "leaf_rel_l2_kernels_vs_f32": gap_k, "ok": ok0})
    if not ok0:
        raise AssertionError(f"step-0 gradients: leaf {worst} is "
                             f"{gap_k[worst]} from f32 (tol {GRAD_REL_TOL})")

    # The default AdamW chain and peak LR, with the schedule's linear
    # warmup: from random weights, 3e-4 from the first step (about lr *
    # sign(g) on every weight) overshoots and the loss of this batch
    # climbs from 0.1 to 2.1 in one step
    model.dropout = 0.1
    tx = make_optimizer(make_lr_schedule(3e-4, 1000, warmup_steps=100,
                                         true_warmup=True))
    state = create_train_state(model, tx, SEED, variables=params,
                               apply_fn=fasttrain.make_apply(model),
                               device=dev)
    step = make_train_step(loss_fn)
    batch = {"image": images, "label": labels}
    want = {k: 0 for k in att.LAUNCHES}
    want.update(attention_block_train=DEPTH, attention_qkv_bwd=DEPTH,
                ln_res_bwd=2 * DEPTH)
    losses, norms, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        reset_launches()                  # the main path: one step
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        per_step.append(dict(att.LAUNCHES))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    reset_launches()
    ev = make_eval_step(state.apply_fn)(state.params, images)
    torch.cuda.synchronize()
    eval_launches = dict(att.LAUNCHES)
    want_eval = {k: DEPTH if k == "attention_block" else 0
                 for k in att.LAUNCHES}
    scores = ev["score"]
    ok = (all(ls == want for ls in per_step) and eval_launches == want_eval
          and all(math.isfinite(v) for v in losses + norms)
          and losses[-1] < losses[0]
          and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all())
          and tuple(scores.shape) == (MAIN_B,))
    emit({"phase": "train", "batch": MAIN_B, "steps": TRAIN_STEPS,
          "dropout": 0.1, "loss": losses, "grad_norm": norms,
          "launches_per_step": per_step[0],
          "launches_equal_every_step": all(ls == per_step[0]
                                           for ls in per_step),
          "eval_launches": eval_launches,
          "eval_score_min": scores.min().item(),
          "eval_score_max": scores.max().item(), "ok": ok})
    if not ok:
        raise AssertionError(
            f"training steps: launches {per_step} (want {want}), eval "
            f"launches {eval_launches}, losses {losses}, grad norms {norms}")
    return state, step, batch, per_step[0]


def _library_calls(bwd, ln, heads, valid):
    """The PyTorch call that computes each training kernel's function,
    where there is one, as a closure to time (not used by the port):
    the backward of ``scaled_dot_product_attention`` with the same key
    mask for the attention backward; ``native_layer_norm_backward`` plus
    the residual add for the LN backward.  The latter recomputes xhat
    from the input, mean and rstd (here xhat, 0 and inv), and takes bf16
    LN vectors."""
    qkv, g = bwd["qkv"], bwd["g"]
    b, tp, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.contiguous().requires_grad_() for t in qkv.view(
        b, tp, 3, heads, d // heads).permute(2, 0, 3, 1, 4))
    mask = (torch.arange(tp, device=qkv.device) < valid).view(1, 1, 1, tp)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask)
    go = g.view(b, tp, heads, d // heads).transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(o, (q, k, v), go, retain_graph=True)

    xh, inv, dxn, g2 = ln["xh"], ln["inv"], ln["dxn"], ln["g"]
    w = ln["lns"].to(xh.dtype)
    bias = torch.zeros_like(w)
    # mean and rstd in the dtype the backend's forward gives them
    _, mean, rstd = torch.ops.aten.native_layer_norm(xh, [xh.shape[-1]], w,
                                                     bias, 1e-6)
    mean, inv = torch.zeros_like(mean), inv.to(rstd.dtype).view(rstd.shape)

    def ln_bwd_lib():
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            dxn, xh, [xh.shape[-1]], mean, inv, w, bias, [True, True, True])
        return dx + g2, dw, db

    return {"attention_qkv_bwd": sdpa_bwd, "ln_res_bwd": ln_bwd_lib}


def profile_step(fn, top: int = 15) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler:
    the wall time of the call, the summed device time of its kernels (so
    the device's idle share) and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"profile_wall_ms": wall_ms, "profile_device_busy_ms": busy_ms,
            "profile_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "profile_top": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]]}


def phase_times(dev, model, serve128, u8, main_err, launches,
                train_launches, train_state, train_step, train_batch) -> list:
    rng = np.random.default_rng(SEED + 3)
    a_in, m_in = block_inputs(rng, MAIN_B, TP, D, HIDDEN, dev)
    bwd, ln = train_inputs(rng, MAIN_B, TP, T, D, dev)
    library = _library_calls(bwd, ln, HEADS, T)
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
        "attention_block_train": (
            lambda: att.attention_block_train_padded(
                **a_in, num_heads=HEADS, valid_len=T),
            lambda: att.attention_block_train_padded_plain(
                **a_in, num_heads=HEADS, valid_len=T),
            attention_train_work(MAIN_B, TP, D, HEADS)),
        "attention_qkv_bwd": (
            lambda: att.attention_qkv_bwd(**bwd, num_heads=HEADS,
                                          valid_len=T),
            lambda: att.attention_qkv_bwd_plain(**bwd, num_heads=HEADS,
                                                valid_len=T),
            attention_bwd_work(MAIN_B, TP, D, HEADS)),
        "ln_res_bwd": (
            lambda: ln_bwd.ln_residual_bwd(**ln),
            lambda: ln_bwd.ln_residual_bwd_plain(**ln),
            ln_bwd_work(MAIN_B * TP, D)),
    }
    every_launch = {**launches, **{k: train_launches[k]
                                   for k in TRAIN_KERNELS}}
    rows = []
    for name, (kernel, plain, (flops, nbytes)) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, per_window=3)
        lib = library.get(name)
        bound_ms, bound_by = bound(
            flops, nbytes,
            PEAK_F32_FLOPS if name == "ln_res_bwd" else PEAK_BF16_FLOPS)
        rows.append({"name": name, "route": "cuda", **KERNELS[name],
                     "launches": every_launch[name],
                     "max_abs_err": main_err[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": time_ms(lib) if lib else None})
    del a_in, m_in, bwd, ln, library

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
    by_name = {r["name"]: r for r in rows}
    kernel_ms = DEPTH * sum(by_name[k]["ms"] for k in SERVING_KERNELS)
    emit({"phase": "times", "batch": MAIN_B, "e2e_ms": e2e_ms,
          "img_per_s": MAIN_B / (e2e_ms / 1e3),
          "kernels_ms_per_forward": kernel_ms, "stem_ms": stem_ms,
          "head_ms": head_ms,
          "bound_ms_per_forward": DEPTH * sum(by_name[k]["bound_ms"]
                                              for k in SERVING_KERNELS),
          "kernels": {r["name"]: {k: r[k] for k in
                                  ("ms", "plain_ms", "bound_ms",
                                   "library_ms")}
                      for r in rows}})

    # the training step (forward, backward, optimizer), dropout on
    step_ms = time_ms(lambda: train_step(train_state, train_batch),
                      windows=3, per_window=3, warmup=2)
    profile = profile_step(lambda: train_step(train_state, train_batch))
    train_kernel_ms = sum(train_launches[k] * by_name[k]["ms"]
                          for k in TRAIN_KERNELS)
    emit({"phase": "times_train", "batch": MAIN_B, "step_ms": step_ms,
          "img_per_s": MAIN_B / (step_ms / 1e3),
          "kernels_ms_per_step": train_kernel_ms,
          "kernels_share_of_step": train_kernel_ms / step_ms,
          "bound_ms_per_step_of_kernels": sum(
              train_launches[k] * by_name[k]["bound_ms"]
              for k in TRAIN_KERNELS),
          "launches_per_step": {k: train_launches[k] for k in TRAIN_KERNELS},
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 2 ** 30, **profile})
    return rows


LAYER_PHASES = ["ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2"]
BATCHGRID_PHASES = ["ln1", "qkv", "attention", "proj", "ln2", "fc1",
                    "fc2_a", "fc2_b"]


def trace_breakdown(launch, phases, repeats: int = 5) -> dict:
    """Per-phase device time of a traced whole-encoder launch: the
    global-timer stamps block 0 writes as it leaves each grid barrier
    (ops/lowlat.py ``trace``), the median of ``repeats`` launches.  Each
    phase's time includes its barrier; the first stamps time bare
    barriers.  Returns the sum and count over the layers per phase name,
    the bare barrier, and the traced launch's total."""
    n = 1 + low._TRACE_BARRIERS + len(phases)
    trace = torch.zeros(n, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(repeats + 1):                  # the first warms up
        launch(trace)
        torch.cuda.synchronize()
        runs.append(trace.diff().double().cpu() / 1e6)   # ns -> ms
    dt = torch.stack(runs[1:]).median(0).values
    bare = dt[:low._TRACE_BARRIERS]
    out = {"barrier_ms": bare.median().item(),
           "total_ms": dt[low._TRACE_BARRIERS:].sum().item(), "phases": {}}
    for name, ms in zip(phases, dt[low._TRACE_BARRIERS:].tolist()):
        acc = out["phases"].setdefault(name, {"ms": 0.0, "count": 0})
        acc["ms"] += ms
        acc["count"] += 1
    return out


def phase_times_small(dev, model, progs, fns, main_err, launches) -> list:
    """Kernel 10 at B = 1 and kernel 11 per 2-item chunk beside their
    bounds and plain versions; the B = 1 forward (and a profile of it);
    the batch-grid forwards; the fastserve forward at the same B."""
    rng = np.random.default_rng(SEED + 8)
    bf = torch.bfloat16
    prep, bprep = progs["lowlat"][0], progs["batch_grid"][0]
    u8 = torch.from_numpy(rng.integers(0, 256, (max(SMALL_B), IMG, IMG, 3),
                                       dtype=np.uint8)).to(dev)
    xp = fastserve.patch_rows(u8[:1], patch_size=PATCH, tp=TP, dtype=bf)
    args10 = (xp, prep["packed_w"], prep["packed_s"], prep["end_w"],
              prep["end_s"], prep["aux"])
    stream, _t = fastserve.padded_stream(bprep["params"]["vit"], u8[:2],
                                         dtype=bf, patch_size=PATCH)
    args11 = (stream, bprep["bg_w"], bprep["bg_s"])
    kw = dict(num_heads=HEADS, valid_len=T)
    hh = prep["end_w"].shape[-1] - D
    timed = {
        "lowlat_encoder": (
            lambda: low.forward_lowlat_e2e(*args10, **kw),
            lambda: low.forward_lowlat_e2e_plain(*args10, **kw),
            lowlat_work(1, DEPTH, hh=hh), nbytes(*args10) + 2 * 4),
        "lowlat_batchgrid": (
            lambda: low.encoder_forward_lowlat_batchgrid(*args11, **kw),
            lambda: low.encoder_forward_lowlat_batchgrid_plain(*args11,
                                                               **kw),
            lowlat_work(2, DEPTH), nbytes(*args11) + nbytes(stream)),
    }
    rows = []
    for name, (kernel, plain, flops, nb) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, per_window=3)
        bound_ms, bound_by = bound(flops, nb)
        rows.append({"name": name, "route": "cuda", **KERNELS[name],
                     "launches": launches[name],
                     "max_abs_err": main_err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "gflop": flops / 1e9, "mbytes": nb / 1e6})

    fast = fastserve.make_serving_fn(model, batch_size=1, mode="fastserve")
    e2e = {}
    for b in SMALL_B:
        ms = time_ms(lambda b=b: fns[b](u8[:b]))
        fast_ms = time_ms(lambda b=b: fast(u8[:b]))
        e2e[str(b)] = {"regime": fastserve.auto_serving_mode(b), "ms": ms,
                       "ms_per_img": ms / b, "fastserve_ms": fast_ms,
                       "fastserve_ms_per_img": fast_ms / b}
    profile = profile_step(lambda: fns[1](u8[:1]))
    m_in = block_inputs(rng, MAIN_B, TP, D, HIDDEN, dev)[1]
    clocks = {"kernel10_b1": clocks_during(timed["lowlat_encoder"][0]),
              "mlp_block_b128": clocks_during(
                  lambda: att.fused_mlp_block(**m_in))}
    del m_in
    breakdown = {
        "lowlat_encoder_b1": trace_breakdown(
            lambda tr: low.forward_lowlat_e2e(*args10, **kw, trace=tr),
            ["stem"] + LAYER_PHASES * DEPTH + ["head_fc1", "head_fc2"]),
        "lowlat_batchgrid_chunk2": trace_breakdown(
            lambda tr: low.encoder_forward_lowlat_batchgrid(*args11, **kw,
                                                            trace=tr),
            BATCHGRID_PHASES * DEPTH)}
    emit({"phase": "times_small", "b1_ms": e2e["1"]["ms"],
          "phase_breakdown": breakdown,
          "kernels": {r["name"]: {k: r[k] for k in
                                  ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "gflop", "mbytes")} for r in rows},
          "e2e": e2e, "b1_profile": profile, "clocks": clocks})
    for r in rows:
        del r["gflop"], r["mbytes"]
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
    low_err, progs = phase_kernels_lowlat(dev, model)
    fns, small_launches = phase_slice_small(dev, model)
    phase_http(model, fns)
    train_state, train_step, train_batch, train_launches = phase_train(dev)
    rows = phase_times(dev, model, serve128, u8, main_err, launches,
                       train_launches, train_state, train_step, train_batch)
    rows += phase_times_small(dev, model, progs, fns, low_err,
                              small_launches)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
