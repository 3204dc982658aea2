"""Bulk scoring: ``eval/runner.py::score_batches`` (pinned upload, one
batch in flight) over the program's scoring function, fed batches of
uint8 faces from a pool in host memory, a closed loop for the whole
window.

The workload's ``entry`` picks the scoring function: ``fastserve``
(``make_fastserve_infer``: bf16, each encoder layer on the attention- and
MLP-block kernels) or ``module`` (``make_infer_fn`` over the port's
module at the configuration's dtype, TF32 off: ``evaluate-all``'s path).
Every answer of the window is compared with the reference's P(live) of
its image.  The workload's ``metric`` names the end-to-end rate the cell
reports: every image of the window over the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from padbench import check, generate, port, weights
from padbench.harness import SPAN, check as limit_check, log
from padbench.reference import vit as ref

WARMUP_BATCHES = 3         # the first builds and loads every kernel
MAX_IMAGES_PER_S = 200000  # sizes the runner's answer arrays


def _infer(cfg, wl, w, device):
    from vit_spoof_detection_pda_tpu_torch.eval.runner import (
        make_fastserve_infer, make_infer_fn)
    dtype = port.dtype_of(cfg["dtype"])
    if wl["entry"] == "fastserve":
        return make_fastserve_infer(port.module(cfg, w, device))
    return make_infer_fn(port.module(cfg, w, device, dtype=dtype),
                         input_dtype=torch.float32)


def _feed(images, b, nb, ctx, fed, *, deadline=None, limit=None):
    """Batch ``k`` is pool batch ``k mod nb`` under the answer indices
    ``k B .. (k + 1) B``; stops at ``deadline`` or after ``limit``
    batches, and counts the batches it gave in ``fed[0]``.  Each batch's
    host work in the runner runs inside the span ``padbench.batch``."""
    k = 0
    while limit is None or k < limit:
        ctx.tracer.tick()
        if deadline is not None and time.perf_counter() >= deadline:
            return
        i = k % nb
        with torch.profiler.record_function(SPAN + "batch"):
            yield {"image": images[i * b:(i + 1) * b],
                   "index": np.arange(k * b, (k + 1) * b)}
        k += 1
        fed[0] = k


def run(ctx) -> dict:
    from vit_spoof_detection_pda_tpu_torch.eval.runner import score_batches
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    pool = generate.pool(ctx.seed, ctx.traffic, cfg["image_size"], dev)
    images, b, nb = pool["images"], pool["batch"], pool["batches"]
    w = weights.make(cfg, ctx.seed, dev)
    infer = _infer(cfg, wl, w, dev)
    del w
    warm = WARMUP_BATCHES
    score_batches(infer, _feed(images, b, nb, ctx, [0], limit=warm),
                  warm * b, batch_size=b, device=dev)
    ctx.setup_done()

    cap = int(ctx.seconds * MAX_IMAGES_PER_S) + b
    ctx.tracer.open()
    fed = [0]
    t0 = time.perf_counter()
    prob1, _ = score_batches(
        infer, _feed(images, b, nb, ctx, fed, deadline=t0 + ctx.seconds,
                     limit=cap // b), cap, batch_size=b, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx.window_closed()
    n = fed[0] * b
    log(f"window {t1 - t0:.3f} s, {n} images")
    del infer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: P(live) of every distinct image of the pool
    w = weights.make(cfg, ctx.seed, dev)
    want = ref.p_live(w, torch.from_numpy(images).to(dev), cfg)
    want = want.cpu().numpy()
    which = np.arange(n) % images.shape[0]
    gaps = check.score_gaps(prob1[:n], want, which)
    lim = wl["limits"]
    return {
        "e2e": {wl["metric"]: n / (t1 - t0)},
        "readings": gaps,
        "attempted": n, "failed": 0,
        "checks": {k: limit_check(gaps[k], v) for k, v in lim.items()},
    }

