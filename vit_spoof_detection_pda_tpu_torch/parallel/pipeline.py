"""GPipe pipeline parallelism for the ViT encoder (counterpart of the JAX
package's ``parallel/pipeline.py``), one process per stage.

The parameter layout is JAX's: the ``block{i}`` subtrees stacked into one
subtree under ``"blocks"`` with a leading layer dimension
(:func:`pack_pipeline_params`), which each stage holds depth / S layers
of (:func:`pipe_layout`; with a ``model`` axis each stacked leaf also
carries its Megatron split on its trailing dimensions), and a pipeline
run's checkpoints store it packed.

:func:`pipeline_apply` runs the whole ``ViTAntiSpoof`` with the encoder
pipelined over the mesh's ``pipe`` axis.  The patch embedding, the final
LayerNorm, the pooling and the head run outside the pipe, on every
stage.  The encoder runs JAX's GPipe schedule (``_pipeline_encoder``
:159): M + S - 1 ticks, stage 0 injecting microbatch i at tick i, stage s
running microbatch i - s through its layers and handing the result to
stage s + 1 (``parallel/collectives.py::send_to`` / ``recv_from``, JAX's
``ppermute``), the last stage emitting microbatch i - (S - 1).  A
process idles where JAX's SPMD program computes a bubble.  The backward
runs the same ticks in reverse, each stage receiving its outputs'
cotangents from the next stage and sending its inputs' to the previous
one (GPipe: the full forward, then the full backward).  The last stage's
outputs reach every stage through ``from_rank`` (JAX's masked ``psum``),
so the loss every stage computes counts once; the embedding's gradient,
which only stage 0's pipeline input has, is summed over the stages
(``copy_to_group``), so every pipe-replicated leaf ends the backward
with the same gradient on every stage.  ``remat`` recomputes each
block's interior in the backward (``torch.utils.checkpoint``), keeping
only the block boundaries.  Inside a stage the blocks run under
``ops/attention.py::manual_attention``: kernel 8 on the rank's
microbatch, on the rank's heads under a model axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import (DATA_AXIS, PIPE_AXIS, ParamLayout, axis_rank, axis_sizes,
                   make_pipe_mesh, param_specs, tp_specs, tree_flatten,
                   tree_unflatten)

__all__ = ["PIPE_AXIS", "make_pipe_mesh", "pack_pipeline_params",
           "unpack_pipeline_params", "stack_block_params",
           "unstack_block_params", "stacked_pipe_specs", "pipe_param_specs",
           "pipe_layout", "pipeline_apply"]


def _is_block_key(k: str) -> bool:
    return k.startswith("block") and k[5:].isdigit()


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(list(xs))
    return np.stack([np.asarray(x) for x in xs])


def _tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_block_params(vit_params: dict, depth: int):
    """Split a ViT parameter dict into ``(stacked_blocks, rest)``: the
    ``block{i}`` subtrees stacked on a new leading layer dimension, and
    everything else (patch embed, cls / pos, final norm) untouched.  A
    tree whose block count is not ``depth`` raises (taking ``depth``
    blocks of a deeper tree would run a truncated model)."""
    n_blocks = sum(1 for k in vit_params if _is_block_key(k))
    if n_blocks != depth:
        raise ValueError(f"param tree has {n_blocks} encoder blocks but "
                         f"depth={depth}")
    blocks = [vit_params[f"block{i}"] for i in range(depth)]
    stacked = _tree_map(lambda *xs: _stack(xs), *blocks)
    rest = {k: v for k, v in vit_params.items() if not _is_block_key(k)}
    return stacked, rest


def unstack_block_params(stacked) -> list:
    """The per-layer subtrees of a stacked ``"blocks"`` subtree."""
    depth = _first_leaf(stacked).shape[0]
    return [_tree_map(lambda x, i=i: x[i], stacked) for i in range(depth)]


def pack_pipeline_params(variables, depth: int):
    """Module variables in the pipeline layout: the vit tree's
    ``block{i}`` subtrees become ONE stacked subtree under ``"blocks"``;
    everything else is untouched."""
    params = dict(variables["params"])
    stacked, rest = stack_block_params(params["vit"], depth)
    params["vit"] = {**rest, "blocks": stacked}
    return {**variables, "params": params}


def unpack_pipeline_params(variables):
    """Inverse of :func:`pack_pipeline_params`: the ``"blocks"`` subtree
    unstacks back into ``block{i}`` subtrees (the plain module layout);
    a tree already in that layout passes through."""
    params = dict(variables["params"])
    vit = dict(params["vit"])
    if "blocks" not in vit:
        return variables
    stacked = vit.pop("blocks")
    for i, bp in enumerate(unstack_block_params(stacked)):
        vit[f"block{i}"] = bp
    params["vit"] = vit
    return {**variables, "params": params}


# --------------------------------------------------------------------------
# Layout of the packed tree over a (data, pipe[, model]) mesh
# --------------------------------------------------------------------------


def stacked_pipe_specs(stacked, *, tp: bool):
    """Specs of a stacked block tree (JAX :265): the leading layer
    dimension over ``pipe``; with ``tp`` each leaf adds its Megatron
    model-axis spec on the trailing dimensions (``mesh._TP_RULES``)."""
    if not tp:
        return _tree_map(lambda _: (PIPE_AXIS,), stacked)
    tails = param_specs(stacked)        # trailing-dim anchored, full rank

    def combine(leaf, tail):
        names = list(tail) + [None] * (leaf.ndim - len(tail))
        names[0] = PIPE_AXIS
        return tuple(names)

    return _tree_map(combine, stacked, tails)


def pipe_param_specs(variables, depth: int, *, tp: bool = False):
    """Specs of the :func:`pack_pipeline_params` layout (JAX :347): the
    ``"blocks"`` subtree's leading layer dimension over ``pipe`` (with
    ``tp``, each leaf's Megatron spec on its trailing dimensions), every
    other leaf replicated (``()``).  The tree has the PACKED variables'
    structure; it is derived from the plain tree's structure alone."""
    params = variables["params"]
    vit_params = params["vit"]
    n_blocks = sum(1 for k in vit_params if _is_block_key(k))
    if n_blocks != depth:
        raise ValueError(f"param tree has {n_blocks} encoder blocks, "
                         f"expected depth={depth}")
    vit_spec = {k: _tree_map(lambda _: (), v)
                for k, v in vit_params.items() if not _is_block_key(k)}
    block0 = vit_params["block0"]
    if tp:
        tails = param_specs(block0)

        def with_pipe(leaf, tail):
            return (PIPE_AXIS,) + tuple(tail) + (None,) * (
                np.ndim(leaf) - len(tail))

        vit_spec["blocks"] = _tree_map(with_pipe, block0, tails)
    else:
        vit_spec["blocks"] = _tree_map(lambda _: (PIPE_AXIS,), block0)
    params_spec = {k: (vit_spec if k == "vit"
                       else _tree_map(lambda _: (), v))
                   for k, v in params.items()}
    return {**{k: _tree_map(lambda _: (), v)
               for k, v in variables.items() if k != "params"},
            "params": params_spec}


def pipe_layout(packed_params, mesh, num_heads: Optional[int] = None
                ) -> ParamLayout:
    """:class:`ParamLayout` of a packed parameter tree (``{"vit": {...,
    "blocks": ...}, "head": ...}``) over a (data, pipe[, model]) mesh:
    the stacked leaves split their layer dimension over ``pipe`` and, with
    a model axis, carry :func:`parallel.mesh.tp_specs`' split on the
    trailing dimensions; every other leaf is replicated."""
    leaves, paths = tree_flatten(packed_params)
    sizes = axis_sizes(mesh)
    tails = tp_specs(paths, leaves, mesh, num_heads)
    specs = []
    for path, leaf, tail in zip(paths, leaves, tails):
        if len(path) > 1 and path[:2] == ("vit", "blocks"):
            if leaf.shape[0] % sizes[PIPE_AXIS]:
                raise ValueError(f"depth {leaf.shape[0]} not divisible by "
                                 f"pipe={sizes[PIPE_AXIS]}")
            specs.append((PIPE_AXIS,) + tuple(tail[1:]))
        else:
            specs.append((None,) * leaf.ndim)
    return ParamLayout(mesh, paths, specs)


# --------------------------------------------------------------------------
# The GPipe schedule
# --------------------------------------------------------------------------


def _block_state(bp: dict) -> dict:
    """An ``EncoderBlock``'s state dict from one layer's JAX-layout
    subtree (views and transposes of its leaves)."""
    sd = {}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"] = bp[name]["scale"]
        sd[f"{name}.bias"] = bp[name]["bias"]
    for mod, node in (("attn.qkv", bp["attn"]["qkv"]),
                      ("attn.proj", bp["attn"]["proj"]),
                      ("mlp.fc1", bp["mlp"]["fc1"]),
                      ("mlp.fc2", bp["mlp"]["fc2"])):
        sd[f"{mod}.weight"] = node["kernel"].t()
        sd[f"{mod}.bias"] = node["bias"]
    return sd


class _Schedule:
    """One GPipe run: this stage's layers (``paths`` / the stacked leaves
    it is given), the pipe group, the microbatch count, the block module
    the layers run through, and the forward's saved microbatch graphs."""

    def __init__(self, module, mesh, microbatches: int, paths, remat: bool):
        self.block = module.vit.blocks[0]
        self.mesh, self.m, self.paths = mesh, microbatches, paths
        self.remat = remat
        self.n_stages = axis_sizes(mesh)[PIPE_AXIS]
        self.stage = axis_rank(mesh, PIPE_AXIS)
        self.group = mesh.get_group(PIPE_AXIS)

    def run_local(self, x, leaves):
        """This stage's layers on one microbatch."""
        from torch.func import functional_call
        from torch.utils.checkpoint import checkpoint

        from ..ops.attention import manual_attention
        stacked = tree_unflatten(self.paths, list(leaves))
        depth = leaves[0].shape[0]
        with manual_attention(self.mesh):
            for i in range(depth):
                sd = _block_state(_tree_map(lambda w, i=i: w[i], stacked))

                def fn(h, sd=sd):
                    return functional_call(self.block, sd, (h,))

                x = (checkpoint(fn, x, use_reentrant=False)
                     if self.remat else fn(x))
        return x

    def forward(self, x, leaves, graph: bool):
        """The forward ticks: the last stage's outputs ``[B_l, T, D]``
        (zeros on the other stages).  ``graph``: keep each microbatch's
        graph for :meth:`backward`, over detached copies of ``leaves``."""
        from .collectives import recv_from, send_to
        s, n, m = self.stage, self.n_stages, self.m
        mbs = x.chunk(m)
        self.ws = ([w.detach().requires_grad_() for w in leaves] if graph
                   else list(leaves))
        self.saved, outs, works = [None] * m, [None] * m, []
        for i in range(m + n - 1):
            j = i - s
            if not 0 <= j < m:
                continue                        # a bubble of this stage
            inp = mbs[j] if s == 0 else recv_from(
                mbs[j].shape, x.dtype, x.device, self.group, s - 1)
            if graph:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    y = self.run_local(inp, self.ws)
                self.saved[j] = (inp, y)
            else:
                y = self.run_local(inp, self.ws)
            if s < n - 1:
                works.append(send_to(y, self.group, s + 1))
            else:
                outs[j] = y.detach()
        for work, _buf in works:
            work.wait()
        return torch.cat(outs) if s == n - 1 else torch.zeros_like(x)

    def backward(self, g):
        """The reverse ticks: ``(dx, dleaves)`` of this stage (``dx`` zero
        past stage 0); ``g`` is the output's cotangent, read on the last
        stage only."""
        from .collectives import recv_from, send_to
        s, n, m = self.stage, self.n_stages, self.m
        gmb = g.chunk(m) if s == n - 1 else None
        dx, works = [None] * m, []
        for i in reversed(range(m + n - 1)):
            j = i - s
            if not 0 <= j < m:
                continue
            inp, y = self.saved[j]
            gy = (gmb[j].to(y.dtype) if s == n - 1 else recv_from(
                y.shape, y.dtype, y.device, self.group, s + 1))
            torch.autograd.backward(y, gy, inputs=[inp] + self.ws)
            self.saved[j] = None
            if s > 0:
                works.append(send_to(inp.grad, self.group, s - 1))
            else:
                dx[j] = inp.grad
        for work, _buf in works:
            work.wait()
        dws = [w.grad if w.grad is not None else torch.zeros_like(w)
               for w in self.ws]
        self.ws = None
        return (torch.cat(dx) if s == 0 else torch.zeros_like(g)), dws


class _GPipe(torch.autograd.Function):
    """The pipelined encoder as one autograd node: its forward and
    backward are the schedule's, with the communication in a fixed
    order on every stage."""

    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        return sched.forward(x, leaves, graph=True)

    @staticmethod
    def backward(ctx, g):
        dx, dws = ctx.sched.backward(g.contiguous())
        return (None, dx, *dws)


def pipeline_apply(module, variables, images, mesh, *, microbatches: int,
                   train: bool = False, generator=None,
                   remat: bool = False) -> torch.Tensor:
    """The ``ViTAntiSpoof`` forward with the encoder pipelined over
    ``mesh``'s ``pipe`` axis (JAX :283): ``images`` are this data rank's
    rows (``parallel/mesh.py::shard_batch``), the logits ``[B_l,
    classes]`` f32 are the same on every stage.  Differentiable in the
    tree's leaves.

    ``variables``: the plain module tree (``block{i}`` subtrees, whole:
    stacked and sliced for this stage here), or the
    :func:`pack_pipeline_params` layout holding this rank's slices
    (:func:`pipe_layout`; the Trainer's).  ``microbatches`` must divide
    the global batch (the data ranks' rows together) into microbatches
    that divide over the data axis, and the depth must divide over the
    stages (JAX's ``ValueError``s).  ``train`` with a ``generator``
    draws the head's dropout masks from it (at the global batch shape
    under a data axis, so every stage draws the same)."""
    from torch.func import functional_call

    from ..models.vit import _dense, patchify
    from ..ops.attention import attention_sharding
    from .collectives import copy_to_group, from_rank

    sizes = axis_sizes(mesh)
    n_stages, n_data = sizes[PIPE_AXIS], sizes.get(DATA_AXIS, 1)
    params = variables["params"]
    vit_params = params["vit"]
    m = microbatches
    b = images.shape[0] * n_data
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches={m}")
    if (b // m) % n_data:
        raise ValueError(f"microbatch size {b // m} not divisible by "
                         f"data={n_data}")
    if module.depth % n_stages:
        raise ValueError(f"depth {module.depth} not divisible by "
                         f"pipe={n_stages}")
    if "blocks" in vit_params:              # this rank's packed slices
        local = vit_params["blocks"]
        n_stacked = _first_leaf(local).shape[0] * n_stages
        if n_stacked != module.depth:
            raise ValueError(f"packed tree has {n_stacked} encoder "
                             f"blocks but module depth={module.depth}")
        rest = {k: v for k, v in vit_params.items() if k != "blocks"}
    else:
        stacked, rest = stack_block_params(vit_params, module.depth)
        layout = pipe_layout({"vit": {"blocks": stacked}}, mesh,
                             module.num_heads)
        leaves, paths = tree_flatten({"vit": {"blocks": stacked}})
        local = tree_unflatten(paths, [layout.shard(w, i)
                                   for i, w in enumerate(leaves)])
        local = local["vit"]["blocks"]
    leaves, paths = tree_flatten(local)
    dt = module.dtype
    pipe = mesh.get_group(PIPE_AXIS)

    with attention_sharding(mesh):
        pe = rest["patch_embed"]
        x = _dense(patchify(images, patch_size=module.patch_size, dtype=dt),
                   pe["kernel"].t(), pe["bias"], dt)
        cls = rest["cls_token"].to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + rest["pos_embed"].to(dt)
        x = copy_to_group(x, pipe)
        sched = _Schedule(module, mesh, m, paths, remat)
        if torch.is_grad_enabled() and (x.requires_grad or any(
                w.requires_grad for w in leaves)):
            y = _GPipe.apply(sched, x, *leaves)
        else:
            y = sched.forward(x, leaves, graph=False)
        y = from_rank(y, pipe, n_stages - 1)
        norm = rest["norm"]
        y = F.layer_norm(y.float(), (y.shape[-1],), norm["scale"].float(),
                         norm["bias"].float(), module.norm_eps).to(dt)
        feats = (y[:, 0] if module.vit.pool == "token"
                 else y[:, 1:].float().mean(1).to(dt))
        head = params["head"]
        sd = {"0.weight": head["norm"]["scale"], "0.bias": head["norm"]["bias"],
              "2.weight": head["fc1"]["kernel"].t(), "2.bias": head["fc1"]["bias"],
              "5.weight": head["fc2"]["kernel"].t(),
              "5.bias": head["fc2"]["bias"]}
        module.classifier.train(train)
        if not (train and generator is not None and module.dropout > 0):
            return functional_call(module.classifier, sd, (feats.float(),))
        devices = [feats.device] if feats.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(generator.initial_seed())
            return functional_call(module.classifier, sd, (feats.float(),))
