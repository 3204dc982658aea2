"""Training: ``train/step.py::make_train_step`` over the fused training
forward (``models/fasttrain.py::make_apply``), ``train/state.py``'s
clip -> AdamW and the focal loss, at the configuration's optimizer
settings.  Each step takes a batch of uint8 faces and labels from a pool
in host memory; the step uploads it and its ``batch_prep`` normalizes it
on the card.  A closed loop: the next step as soon as the last returns.

Set-up builds the one training state, drives it through its first three
steps with the window's own call and feed (pool batches 0, 1 and 2: rows
that all differ), keeps what the comparison needs, and hands the same
state to the window.  After the window the reference trains its own copy
of the same weights on the same three batches with the same dropout
masks, and the two are compared: each leaf's first gradient as the
optimizer got it (AdamW's first moment after one step over
``1 - beta1``), and each leaf's norm of the change after three steps.
The workload's ``mlp_mode`` picks the training MLP's route.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from padbench import check, generate, port, weights
from padbench.harness import SPAN, check as limit_check, log
from padbench.reference import vit as ref

REF_STEPS = 3


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout generator, derived as the
    program derives it from the state's seed and step
    (``train/step.py::step_generator``), so the reference draws the same
    keep masks on the same device."""
    s = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def timm_key(path) -> str:
    """A leaf path of the program's tree (the JAX layout) -> its key in
    the published layout, to judge the program's leaves against the
    reference's."""
    s = ".".join(path)
    s = re.sub(r"^vit\.block(\d+)\.", r"vit.blocks.\1.", s)
    s = s.replace("vit.patch_embed.", "vit.patch_embed.proj.")
    s = re.sub(r"^head\.norm\.", "classifier.0.", s)
    s = re.sub(r"^head\.fc1\.", "classifier.2.", s)
    s = re.sub(r"^head\.fc2\.", "classifier.5.", s)
    return re.sub(r"\.(kernel|scale)$", ".weight", s)


def timm_leaf(path, v, cfg) -> torch.Tensor:
    """A leaf of the program's tree in the published layout: a Dense
    ``[in, out]`` kernel transposed, the patch-GEMM kernel ``[p*p*C, D]``
    back to the conv's ``[D, C, p, p]``."""
    if path[-1] != "kernel":
        return v
    if path[-2] == "patch_embed":
        p, c = cfg["patch_size"], cfg["num_channels"]
        return v.reshape(p, p, c, -1).permute(3, 2, 0, 1)
    return v.t()


def host_copy(state, cfg, leaves, scale: float = 1.0) -> dict:
    """``{timm key: leaf * scale}`` copied to host memory."""
    return {timm_key(p): timm_leaf(p, v.detach(), cfg).to(
        "cpu", copy=True).mul_(scale) for p, v in zip(state.paths, leaves)}


def build(cfg, w, device, seed: int, mlp_mode: str):
    """``(state, step)`` of the program at the configuration's
    settings, its training MLP on the route ``mlp_mode``."""
    from vit_spoof_detection_pda_tpu_torch.models.fasttrain import make_apply
    from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn
    from vit_spoof_detection_pda_tpu_torch.train.driver import make_prep_fn
    from vit_spoof_detection_pda_tpu_torch.train.schedule import (
        make_lr_schedule)
    from vit_spoof_detection_pda_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    from vit_spoof_detection_pda_tpu_torch.train.step import make_train_step
    o = cfg["optimizer"]
    model = port.module(cfg, w, device, dtype=port.dtype_of(cfg["dtype"]))
    sched = make_lr_schedule(o["learning_rate"], o["total_steps"],
                             o["warmup_steps"], o["min_lr"], False)
    tx = make_optimizer(sched, weight_decay=o["weight_decay"],
                        beta1=o["beta1"], beta2=o["beta2"],
                        max_grad_norm=o["max_grad_norm"])
    state = create_train_state(
        model, tx, seed=seed, device=device,
        apply_fn=make_apply(model, mlp_mode=mlp_mode))
    loss = make_loss_fn("focal", focal_alpha=o["focal_alpha"],
                        focal_gamma=o["focal_gamma"])
    prep = make_prep_fn((), aug_dtype=cfg["dtype"])
    return state, make_train_step(loss, batch_prep=prep)


def run(ctx) -> dict:
    cfg, dev = ctx.config, ctx.device
    pool = generate.pool(ctx.seed, ctx.traffic, cfg["image_size"], dev)
    images, labels = pool["images"], pool["labels"]
    b, nb = pool["batch"], pool["batches"]
    seed = generate.sub_seed(ctx.seed, 4)
    w = weights.make(cfg, ctx.seed, dev)
    state, step = build(cfg, w, dev, seed, ctx.workload["mlp_mode"])
    del w

    def batch(k):
        i = k % nb
        return {"image": images[i * b:(i + 1) * b],
                "label": labels[i * b:(i + 1) * b]}

    def one(k):
        nonlocal state
        with torch.profiler.record_function(SPAN + "step"):
            state, metrics = step(state, batch(k))
        return metrics

    # what the comparison needs, kept in host memory off the card
    p0 = host_copy(state, cfg, state.leaves())
    losses, g1 = [], None
    for k in range(REF_STEPS):
        losses.append(one(k)["loss"])
        if k == 0:
            g1 = host_copy(state, cfg, state.opt_state["mu"],
                           1.0 / (1.0 - cfg["optimizer"]["beta1"]))
    d3 = {k: v - p0[k] for k, v in
          host_copy(state, cfg, state.leaves()).items()}
    losses = [float(x) for x in losses]
    del p0
    ctx.setup_done()

    ctx.tracer.open()
    k = REF_STEPS
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        ctx.tracer.tick()
        if time.perf_counter() >= deadline:
            break
        one(k)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctx.window_closed()
    steps = k - REF_STEPS
    log(f"window {t1 - t0:.3f} s, {steps} steps")
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    w0 = weights.make(cfg, ctx.seed, dev)
    feed = [(torch.from_numpy(batch(i)["image"]).to(dev),
             torch.from_numpy(batch(i)["label"]).to(dev))
            for i in range(REF_STEPS)]
    out = ref.train_steps(w0, feed, [step_seed(seed, s)
                                     for s in range(REF_STEPS)],
                          cfg, cfg["optimizer"])
    gaps = check.training_gaps(g1, d3, out, w0)
    log(f"losses {losses} reference {out['loss']}")
    lim = ctx.workload["limits"]
    return {
        "e2e": {"train_img_per_s": steps * b / (t1 - t0)},
        "readings": dict(gaps, losses=losses, ref_losses=out["loss"]),
        "attempted": steps, "failed": 0,
        "checks": {k: limit_check(gaps[k], v) for k, v in lim.items()},
    }
