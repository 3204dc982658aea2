"""Train state and optimizer (counterpart of the JAX package's
``train/state.py``).

The optimizer is the JAX package's optax chain written out over the
parameter tensors: clip by global norm -> AdamW -> an optional EMA of the
parameters -> an optional accumulation of micro-gradients that applies
their **mean** every k steps (``optax.MultiSteps``).  Fed the same
gradients it tracks optax: the clip divides by the norm alone (no
``+ 1e-6`` as ``torch.nn.utils.clip_grad_norm_`` adds), the schedule is
read at the update count before the update, Adam's bias corrections and
the decoupled weight decay are optax's.

**The update happens in place**: :meth:`Optimizer.update` and
:meth:`TrainState.apply_gradients` overwrite the parameter tensors and
the optimizer state instead of returning new ones (the JAX state is
immutable), so no second copy of the parameters or of Adam's moments is
ever held.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


def tree_flatten(tree, path=()):
    """``(leaves, paths)`` of a nested dict, keys in sorted order (JAX's
    order for dicts)."""
    if isinstance(tree, dict):
        leaves, paths = [], []
        for k in sorted(tree):
            lv, pt = tree_flatten(tree[k], path + (k,))
            leaves += lv
            paths += pt
        return leaves, paths
    return [tree], [path]


def tree_unflatten(paths, leaves) -> dict:
    """The nested dict with ``leaves`` at ``paths``."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def global_norm_f32(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, squares summed in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """Global-norm clip -> AdamW [-> EMA of the params] [-> mean of k
    micro-gradients], on lists of f32 parameter tensors (the leaves of
    the parameter tree in :func:`tree_flatten` order)."""

    def __init__(self, learning_rate, *, weight_decay: float = 0.05,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
                 gradient_accumulation_steps: int = 1,
                 ema_decay: Optional[float] = None):
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
        if gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda count: learning_rate))
        self.weight_decay, self.beta1, self.beta2 = weight_decay, beta1, beta2
        self.eps, self.max_grad_norm = eps, max_grad_norm
        self.every_k, self.ema_decay = gradient_accumulation_steps, ema_decay

    def init(self, params) -> dict:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {
            "count": 0,                  # inner (AdamW) updates so far
            "mu": zeros,
            "nu": [z.clone() for z in zeros],
            "ema": (None if self.ema_decay is None
                    else [p.detach().clone() for p in params]),
            "mini_step": 0,
            "acc": (None if self.every_k == 1
                    else [z.clone() for z in zeros]),
        }

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> bool:
        """One step on ``grads``, in place on ``params`` and ``state``.
        Returns whether the parameters moved (False on the micro-steps of
        an accumulation)."""
        grads = [g.float() for g in grads]
        if self.every_k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / (n + 1))
            if n < self.every_k - 1:
                state["mini_step"] = n + 1
                return False
            grads = [a.clone() for a in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
            state["mini_step"] = 0
        self._inner(grads, state, params)
        return True

    def _inner(self, grads, state, params):
        """clip -> AdamW [-> EMA] over all leaves at once (``torch._foreach``
        ops: a few launches per step instead of a dozen per leaf); the
        scalars are rounded to f32 as optax computes them."""
        f32 = np.float32
        if self.max_grad_norm is not None:
            g_norm = float(global_norm_f32(grads))
            if not f32(g_norm) < f32(self.max_grad_norm):
                grads = torch._foreach_div(grads, g_norm)
                torch._foreach_mul_(grads, self.max_grad_norm)
        count = state["count"]
        bc1 = float(f32(1) - f32(self.beta1) ** f32(count + 1))
        bc2 = float(f32(1) - f32(self.beta2) ** f32(count + 1))
        lr = float(f32(self.lr(count)))
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, grads, alpha=1 - self.beta1)
        torch._foreach_mul_(nu, self.beta2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1 - self.beta2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_add_(params, u, alpha=-lr)
        if state["ema"] is not None:
            torch._foreach_mul_(state["ema"], self.ema_decay)
            torch._foreach_add_(state["ema"], params,
                                alpha=1.0 - self.ema_decay)
        state["count"] = count + 1


def make_optimizer(learning_rate, *, weight_decay: float = 0.05,
                   beta1: float = 0.9, beta2: float = 0.999,
                   max_grad_norm: Optional[float] = 1.0,
                   gradient_accumulation_steps: int = 1,
                   ema_decay: Optional[float] = None) -> Optimizer:
    """The JAX package's chain: global-norm clip (``max_grad_norm`` None
    turns it off) -> AdamW (``learning_rate`` a float or a schedule of
    the update count) [-> EMA of the post-update params] [-> the mean of
    ``gradient_accumulation_steps`` micro-gradients]."""
    return Optimizer(learning_rate, weight_decay=weight_decay, beta1=beta1,
                     beta2=beta2, max_grad_norm=max_grad_norm,
                     gradient_accumulation_steps=gradient_accumulation_steps,
                     ema_decay=ema_decay)


def find_ema_params(train_state) -> Optional[dict]:
    """The EMA shadow parameters as a tree, or None without EMA."""
    ema = train_state.opt_state["ema"]
    return None if ema is None else tree_unflatten(train_state.paths, ema)


@dataclasses.dataclass
class TrainState:
    """Parameters (a JAX-layout tree of f32 leaf tensors that require
    grad), optimizer state, step and the seed the per-step dropout
    generators derive from."""

    step: int
    params: dict
    opt_state: dict
    seed: int
    apply_fn: Callable
    tx: Optimizer
    paths: list = dataclasses.field(default_factory=list)

    def leaves(self) -> list:
        return tree_flatten(self.params)[0]

    def apply_gradients(self, grads) -> "TrainState":
        """One optimizer step on ``grads`` (leaves in :func:`tree_flatten`
        order), in place; returns the state itself."""
        self.tx.update(grads, self.opt_state, self.leaves())
        self.step += 1
        return self


def create_train_state(module, tx: Optimizer, seed: int = 0, *,
                       variables: Any = None, apply_fn=None,
                       device=None, opt_arrays: Optional[dict] = None
                       ) -> TrainState:
    """A :class:`TrainState` for the port's ``ViTAntiSpoof``: parameters
    from ``variables`` (a JAX-layout ``{"params": ...}`` tree of arrays
    or tensors) or from the module's own weights, as f32 tensors on
    ``device`` (the card unless ``device="cpu"``), and ``apply_fn``
    defaulting to :func:`..models.fasttrain.make_apply` in bf16."""
    from ..models.convert import antispoof_from_torch
    from ..models.fasttrain import make_apply

    device = resolve_device(device)
    if opt_arrays is not None:
        variables = {"params": opt_arrays["params"]}
    if variables is None:
        variables = antispoof_from_torch(module.state_dict())
    leaves, paths = tree_flatten(variables["params"])
    # contiguous copies: the converter hands the kernels' [in, out]
    # matrices back as transposed views, which the card's kernels refuse
    leaves = [torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a).to(device=device, dtype=torch.float32)
              .clone(memory_format=torch.contiguous_format).requires_grad_()
              for a in leaves]
    state = TrainState(step=0, params=tree_unflatten(paths, leaves),
                       opt_state=tx.init(leaves), seed=seed,
                       apply_fn=apply_fn or make_apply(module), tx=tx,
                       paths=paths)
    if opt_arrays is not None:
        load_opt_arrays(state, opt_arrays)
    return state


def load_opt_arrays(state: TrainState, arrays: dict) -> TrainState:
    """Carry a JAX ``TrainState`` across (``models/convert.py::
    train_state_arrays``): its step, AdamW count and moments, and EMA
    shadow, copied in place into ``state`` (the parameters come through
    ``create_train_state``).  Raises where the two optimizers' shapes
    disagree (EMA on one side only, another leaf count)."""
    opt = state.opt_state
    if (arrays["ema"] is None) != (opt["ema"] is None):
        raise ValueError("EMA is on in one optimizer and off in the other")
    with torch.no_grad():
        for key in ("mu", "nu", "ema"):
            if opt[key] is None:
                continue
            if len(arrays[key]) != len(opt[key]):
                raise ValueError(f"{key}: {len(arrays[key])} leaves for "
                                 f"{len(opt[key])} parameters")
            for dst, src in zip(opt[key], arrays[key]):
                dst.copy_(torch.as_tensor(np.asarray(src)).to(dst))
    opt["count"] = int(arrays["count"])
    state.step = int(arrays["step"])
    return state
