"""Train and eval steps (counterpart of the JAX package's
``train/step.py``, without a mesh).

A step runs the forward and the backward through ``state.apply_fn``
(the kernels on the card), the optimizer in place, and returns the
metrics as 0-d tensors on the device: nothing waits for the card.  The
dropout generator of a step is derived from ``(state.seed, state.step)``,
so a resumed run replays the same masks (the JAX ``fold_in(rng, step)``).

Pool mode (``train/pool.py``): a batch with ``index`` carries the
device-resident pool as its ``image``; the step gathers its rows on the
card with ``ops/gather.py::pool_gather`` (kernel 14) before
``batch_prep``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.gather import pool_gather
from .state import TrainState, global_norm_f32, tree_flatten

_PREP_SALT = 104729


def step_generator(seed: int, step: int, device, salt: Optional[int] = None
                   ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, step)``
    (and ``salt``): the same triple gives the same random stream."""
    words = [seed, step] + ([] if salt is None else [salt])
    s = np.random.SeedSequence(words).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(s[0]) << 31) ^ int(s[1]))
    return gen


def _to(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def make_train_step(loss_fn: Callable, *, batch_prep: Optional[Callable] = None):
    """``step(state, batch) -> (state, metrics)``.

    ``loss_fn(logits, labels) -> scalar``.  ``batch``: ``{"image":
    normalized f32 [B, H, W, 3], "label": int [B]}``, arrays or tensors;
    or, in pool mode, ``{"image": the pool [N, H, W, 3], "index": host
    int [B], "label": int [B]}``, whose rows are gathered on the pool's
    device first (other keys, such as ``group``, are ignored).
    ``batch_prep(generator, images) -> images`` runs next, with a
    generator of its own derived from the step.  The state's parameters
    and optimizer state are updated in place.  Metrics: ``loss``,
    ``accuracy`` and ``grad_norm`` (the global norm of the raw gradients,
    squares summed in f32)."""

    def step(state: TrainState, batch):
        leaves = state.leaves()
        dev = leaves[0].device
        images, labels = _to(batch["image"], dev), _to(batch["label"], dev)
        if "index" in batch:
            images = pool_gather(images, batch["index"])
        labels = labels.long()
        if batch_prep is not None:
            images = batch_prep(
                step_generator(state.seed, state.step, dev, _PREP_SALT),
                images)
        gen = step_generator(state.seed, state.step, dev)
        logits = state.apply_fn({"params": state.params}, images, train=True,
                                generator=gen)
        loss = loss_fn(logits, labels)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {
            "loss": loss.detach(),
            "accuracy": (logits.detach().argmax(-1) == labels).float().mean(),
            "grad_norm": global_norm_f32(grads),
        }
        state.apply_gradients(grads)
        return state, metrics

    return step


def make_eval_step(apply_fn: Callable, *, positive_index: int = 1):
    """``step(params, images) -> {"pred", "score", "logits"}`` with grad
    off: ``score`` is column ``positive_index`` of the softmax (P(live)
    in the train/test stack)."""

    @torch.no_grad()
    def step(params, images):
        dev = tree_flatten(params)[0][0].device
        logits = apply_fn({"params": params}, _to(images, dev))
        probs = torch.softmax(logits.float(), dim=-1)
        return {"pred": logits.argmax(-1), "score": probs[:, positive_index],
                "logits": logits}

    return step
