"""Train and eval steps (counterpart of the JAX package's
``train/step.py``).

A step runs the forward and the backward through ``state.apply_fn``
(the kernels on the card), the optimizer in place, and returns the
metrics as 0-d tensors on the device: nothing waits for the card.  The
dropout generator of a step is derived from ``(state.seed, state.step)``,
so a resumed run replays the same masks (the JAX ``fold_in(rng, step)``).

Pool mode (``train/pool.py``): a batch with ``index`` carries the
device-resident pool as its ``image``; the step gathers its rows on the
card with ``ops/gather.py::pool_gather`` (kernel 14) before
``batch_prep``.

Under a mesh (``parallel/mesh.py``; one process per rank) a step takes
this rank's rows of the batch (its data block; every rank of a sequence
group the same rows) and runs the forward under ``attention_sharding``.
The logits of the data group's ranks are gathered, so every rank
computes the loss and metrics of the GLOBAL batch; each rank's gradient
is then its own rows' and tokens' share of the global gradient, and one
all-reduce (sum) over the ranks that hold a copy of a leaf gives every
rank the single-card gradient of the global-batch loss
(:func:`reduce_gradients`).

A step opens four spans (``utils/profiling.py::annotate``), in order:
``vsd.train.input`` (the upload, the pool gather, ``batch_prep``),
``vsd.train.forward`` (the forward and the loss), ``vsd.train.backward``
(the gradients and their all-reduce) and ``vsd.train.update`` (the
metrics' global norm, the clip with its host sync, AdamW).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.attention import attention_sharding
from ..ops.gather import pool_gather
from ..utils.profiling import annotate
from .state import TrainState, tree_flatten

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


def reduce_gradients(grads, mesh, layout=None) -> list:
    """Sum each gradient over the ranks whose shares make it up, in place:
    under a seq axis the whole data x seq group (each rank holds its
    tokens' share); otherwise the data group alone.  A leaf that a model
    or pipe axis splits or replicates needs nothing more: with Megatron's
    operators every model rank computes the whole gradient of a
    replicated leaf and its own of a split one, and every stage ends the
    pipeline's backward with the same gradient of a pipe-replicated leaf
    (``parallel/pipeline.py``).  An FSDP leaf's gradient arrives summed
    over the data group already (its gather's backward reduce-scatters),
    and is left alone."""
    from ..parallel.collectives import all_reduce_sum
    from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, axis_sizes
    sizes = axis_sizes(mesh)
    if sizes.get(SEQ_AXIS, 1) > 1:
        group = None
    elif sizes.get(DATA_AXIS, 1) > 1:
        group = mesh.get_group(DATA_AXIS)
    else:
        return grads
    todo = [g for i, g in enumerate(grads)
            if layout is None or DATA_AXIS not in layout.axes(i)]
    if todo:
        all_reduce_sum(todo, group)
    return grads


def make_train_step(loss_fn: Callable, *, batch_prep: Optional[Callable] = None,
                    mesh=None):
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
    squares summed in f32).  Under ``mesh`` the batch holds this rank's
    rows and the metrics are the global batch's (the module docstring)."""
    data_group = None
    if mesh is not None:
        from ..parallel.collectives import all_gather_rows, gather_rows
        from ..parallel.mesh import DATA_AXIS
        data_group = mesh.get_group(DATA_AXIS)

    def step(state: TrainState, batch):
        with annotate("vsd.train.input"):
            leaves = state.leaves()
            dev = leaves[0].device
            images = _to(batch["image"], dev)
            labels = _to(batch["label"], dev)
            if "index" in batch:
                images = pool_gather(images, batch["index"])
            labels = labels.long()
            if batch_prep is not None:
                images = batch_prep(
                    step_generator(state.seed, state.step, dev, _PREP_SALT),
                    images)
        with annotate("vsd.train.forward"):
            gen = step_generator(state.seed, state.step, dev)
            with attention_sharding(mesh):
                logits = state.apply_fn({"params": state.params}, images,
                                        train=True, generator=gen)
            if data_group is not None:
                logits = gather_rows(logits, data_group)
                labels = all_gather_rows(labels, data_group)
            loss = loss_fn(logits, labels)
        with annotate("vsd.train.backward"):
            grads = list(torch.autograd.grad(loss, leaves))
            if mesh is not None:
                grads = reduce_gradients(grads, mesh, state.layout)
        with annotate("vsd.train.update"):
            metrics = {
                "loss": loss.detach(),
                "accuracy": (logits.detach().argmax(-1)
                             == labels).float().mean(),
                "grad_norm": state.grad_norm(grads),
            }
            state.apply_gradients(grads)
        return state, metrics

    return step


def make_eval_step(apply_fn: Callable, *, positive_index: int = 1,
                   mesh=None):
    """``step(params, images) -> {"pred", "score", "logits"}`` with grad
    off: ``score`` is column ``positive_index`` of the softmax (P(live)
    in the train/test stack).  Under ``mesh``: this rank's rows, the
    forward under ``attention_sharding``."""

    @torch.no_grad()
    def step(params, images):
        dev = tree_flatten(params)[0][0].device
        with attention_sharding(mesh):
            logits = apply_fn({"params": params}, _to(images, dev))
        probs = torch.softmax(logits.float(), dim=-1)
        return {"pred": logits.argmax(-1), "score": probs[:, positive_index],
                "logits": logits}

    return step
