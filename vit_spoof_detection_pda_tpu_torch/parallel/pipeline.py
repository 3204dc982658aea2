"""The pipeline-parallel parameter layout (counterpart of the packing
half of the JAX package's ``parallel/pipeline.py``, :101-155).

The JAX pipeline stacks the ViT's ``block{i}`` subtrees into one subtree
under ``"blocks"`` with a leading layer dimension (sharded over the
``pipe`` axis there), and its checkpoints of a pipeline run store that
packed layout.  These functions convert between the two layouts on
numpy or torch trees, so a packed JAX checkpoint reads into the port's
plain per-layer tree (``utils/checkpoint.py``).  The GPipe schedule
itself (JAX ``pipeline_apply``) is ROADMAP Queue 1 item 9b.
"""

from __future__ import annotations

import numpy as np
import torch


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
