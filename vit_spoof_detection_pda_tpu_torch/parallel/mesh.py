"""Mesh construction and sharding rules (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives.  The port runs one process per rank (``torchrun``, or
``torch.multiprocessing`` in the tests and ``chip_smoke.py``) over a
``torch.distributed`` process group, and a mesh is a ``DeviceMesh`` whose
dimension names are the JAX axis names:

- ``("data", "seq")`` (:func:`make_seq_mesh`): batches shard over
  ``data``, tokens over ``seq``; the attention all-gathers K and V along
  ``seq`` and runs kernel 12 on the rank's query block
  (``ops/attention.py::_sp_sharded``);
- ``("data", "model")`` (:func:`make_mesh`): with ``model == 1`` pure
  data parallelism (each rank runs the single-card path on its rows and
  the gradients are all-reduced, ``parallel/collectives.py``), optionally
  with the FSDP layout (:func:`shard_params_fsdp`); a model axis larger
  than 1 is Megatron tensor parallelism (:func:`shard_params`): each rank
  holds its columns of qkv and fc1 and its rows of proj and fc2, and the
  attention runs kernel 8 on the rank's heads;
- ``("data", "pipe"[, "model"])`` (:func:`make_pipe_mesh`): the GPipe
  schedule of ``parallel/pipeline.py``, each stage holding depth / pipe
  layers, with tensor parallelism inside each stage when ``model > 1``.

The Megatron and FSDP rule tables (:func:`param_specs`,
:func:`fsdp_param_specs`) are kept as data over the JAX-layout parameter
tree, each spec an axis-name tuple (``()`` replicated, ``(None,
"model")`` a column split).  :class:`ParamLayout` applies them: each rank
keeps only its own slice of a sharded leaf, and gathers the full leaf
where a checkpoint or an evaluation needs it.
"""

from __future__ import annotations

import math
import os
import re
from typing import Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


def _dist():
    import torch.distributed as dist
    return dist


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    dist = _dist()
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    dist = _dist()
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def is_primary() -> bool:
    """Rank 0 (or no process group): the rank that writes checkpoints,
    telemetry and result files."""
    return rank() == 0


def init_multi_host(backend: Optional[str] = None, **kwargs):
    """Join the process group of a multi-process run (JAX
    ``init_multi_host`` :27); returns ``(rank, world_size)``.

    Call once per process before :func:`make_mesh`.  The rendezvous comes
    from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) unless ``kwargs`` give
    ``init_method``, ``rank`` and ``world_size`` (a ``tcp://`` address).
    ``backend`` defaults to NCCL on a CUDA machine and gloo elsewhere.
    On a CUDA machine the process takes card ``LOCAL_RANK`` (torchrun's),
    else its rank modulo the cards (gloo ranks may share one card).  A
    process group that exists already is kept."""
    dist = _dist()
    if not dist.is_initialized():
        cuda = torch.cuda.is_available()
        dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                                **kwargs)
        if cuda:
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return dist.get_rank(), dist.get_world_size()


def mesh_shape(first: int, second: int, n: int, second_name: str):
    """``(first, second)`` sizes of a two-axis mesh over ``n`` ranks with
    the JAX checks: ``first = -1`` takes the remaining ranks."""
    if first == -1:
        if n % second:
            raise ValueError(f"{n} devices not divisible by "
                             f"{second_name}={second}")
        first = n // second
    if first * second != n:
        raise ValueError(f"mesh {first}x{second} != {n} devices")
    return first, second


def _device_mesh(shape, names, device_type: Optional[str]):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    sub-groups on the default group's backend (gloo stays gloo for every
    dimension, so several ranks may share one card)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs a torch.distributed process group: "
                           "call parallel.init_multi_host() first (or "
                           "launch under torchrun)")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = dist.get_backend()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names),
                            backend_override={n: backend for n in names})


def make_mesh(data: int = -1, model: int = 1, *,
              device_type: Optional[str] = None):
    """A (data, model) mesh over every rank (JAX :44); ``data=-1`` takes
    the remaining ranks."""
    shape = mesh_shape(data, model, world_size(), "model")
    return _device_mesh(shape, (DATA_AXIS, MODEL_AXIS), device_type)


def make_seq_mesh(seq: int, data: int = 1, *,
                  device_type: Optional[str] = None):
    """A (data, seq) mesh for sequence parallelism (JAX :58): the seq axis
    is minor, so the ranks of one sequence group are adjacent (one node's
    NVLink peers under torchrun); ``data=-1`` takes the remaining
    ranks."""
    data, seq = mesh_shape(data, seq, world_size(), "seq")
    return _device_mesh((data, seq), (DATA_AXIS, SEQ_AXIS), device_type)


def check_sharding(sharding_cfg):
    """The JAX ``mesh_from_config`` rules (:73) on a ``ShardingConfig``:
    raise ``ValueError`` on layouts that cannot compose.  Returns
    ``(data, model, seq, pipe)``."""
    model = int(getattr(sharding_cfg, "model_parallel", 1))
    seq = int(getattr(sharding_cfg, "seq_parallel", 1))
    pipe = int(getattr(sharding_cfg, "pipeline_parallel", 1))
    data = int(getattr(sharding_cfg, "data_parallel", -1))
    fsdp = bool(getattr(sharding_cfg, "fsdp", False))
    if seq > 1 and (model > 1 or pipe > 1):
        raise ValueError(
            f"seq_parallel={seq} is mutually exclusive with "
            f"model_parallel={model} / pipeline_parallel={pipe}")
    if fsdp and (model > 1 or seq > 1 or pipe > 1):
        # silently dropping fsdp would leave the user believing the ~1/n
        # optimizer-memory saving is active
        raise ValueError(
            "fsdp composes with pure data parallelism only (got "
            f"model_parallel={model}, seq_parallel={seq}, "
            f"pipeline_parallel={pipe})")
    return data, model, seq, pipe


def pipe_mesh_shape(pipe: int, data: int, model: int, n: int):
    """``(data, pipe, model)`` sizes of a pipeline mesh over ``n`` ranks
    with the JAX checks (``parallel/pipeline.py::make_pipe_mesh`` :72):
    ``data = -1`` takes the remaining ranks."""
    if data == -1:
        if n % (pipe * model):
            raise ValueError(f"{n} devices not divisible by "
                             f"pipe*model={pipe * model}")
        data = n // (pipe * model)
    if data * pipe * model != n:
        raise ValueError(f"mesh {data}x{pipe}x{model} != {n} devices")
    return data, pipe, model


def make_pipe_mesh(pipe: int, data: int = 1, model: int = 1, *,
                   device_type: Optional[str] = None):
    """A (data, pipe[, model]) mesh for the GPipe schedule (JAX
    ``parallel/pipeline.py`` :72): ``model > 1`` adds a tensor-parallel
    axis inside each stage, laid out minor-most so a stage's per-layer
    all-reduces stay among adjacent ranks; ``data=-1`` takes the
    remaining ranks."""
    data, pipe, model = pipe_mesh_shape(pipe, data, model, world_size())
    if model == 1:
        return _device_mesh((data, pipe), (DATA_AXIS, PIPE_AXIS),
                            device_type)
    return _device_mesh((data, pipe, model),
                        (DATA_AXIS, PIPE_AXIS, MODEL_AXIS), device_type)


def config_layout(sharding_cfg, n: Optional[int] = None) -> dict:
    """``{axis name: size}`` of the mesh :func:`mesh_from_config` builds
    over ``n`` ranks (the process group's by default):
    ``pipeline_parallel > 1`` -> (data, pipe[, model]); ``seq_parallel >
    1`` -> (data, seq); otherwise (data, model); ``data_parallel = -1``
    takes the remaining ranks."""
    data, model, seq, pipe = check_sharding(sharding_cfg)
    n = world_size() if n is None else n
    if pipe > 1:
        shape = pipe_mesh_shape(pipe, data, model, n)
        names = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS)
        return dict(zip(names[:2 if model == 1 else 3], shape))
    if seq > 1:
        return dict(zip((DATA_AXIS, SEQ_AXIS),
                        mesh_shape(data, seq, n, "seq")))
    return dict(zip((DATA_AXIS, MODEL_AXIS),
                    mesh_shape(data, model, n, "model")))


def mesh_from_config(sharding_cfg, *, device_type: Optional[str] = None):
    """The training mesh a ``config.ShardingConfig`` describes (JAX :73),
    laid out by :func:`config_layout`."""
    layout = config_layout(sharding_cfg)
    return _device_mesh(tuple(layout.values()), tuple(layout), device_type)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 if the mesh lacks it)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def batch_spec() -> tuple:
    """Batches shard their leading dim over the data axis."""
    return (DATA_AXIS,)


def shard_batch(batch: dict, mesh, *, device=None) -> dict:
    """This rank's rows of a GLOBAL batch on ``device`` (JAX :203): its
    contiguous block along the data axis, every rank of one sequence
    group the same rows.  The global row count must divide by the data
    axis."""
    n_data = axis_sizes(mesh).get(DATA_AXIS, 1)
    lo = axis_rank(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            import numpy as np
            v = torch.as_tensor(np.asarray(v))
        if v.shape[0] % n_data:
            raise ValueError(
                f"batch of {v.shape[0]} rows does not divide over the "
                f"{n_data}-way data axis")
        per = v.shape[0] // n_data
        v = v[lo * per:(lo + 1) * per]
        out[k] = v if device is None else v.to(device)
    return out


# Tensor-parallel rules for the JAX-layout parameter tree, matched against
# the '/'-joined path; first hit wins.  Column-split the up-projections
# (qkv, fc1), row-split the down-projections (proj, fc2): the Megatron
# pattern (JAX :145).
_TP_RULES = [
    (re.compile(r".*attn/qkv/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r".*attn/qkv/bias$"), (MODEL_AXIS,)),
    (re.compile(r".*attn/proj/kernel$"), (MODEL_AXIS, None)),
    (re.compile(r".*mlp/fc1/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r".*mlp/fc1/bias$"), (MODEL_AXIS,)),
    (re.compile(r".*mlp/fc2/kernel$"), (MODEL_AXIS, None)),
]


def _spec_for_path(path: str, ndim: int) -> tuple:
    for pat, spec in _TP_RULES:
        if pat.match(path):
            if len(spec) == ndim:
                return spec
            if len(spec) < ndim:
                # stacked layouts carry leading layer dims: anchor the rule
                # to the trailing dims
                return (None,) * (ndim - len(spec)) + spec
            return ()    # first name-match wins; rank too low: replicate
    return ()


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params) -> dict:
    """Megatron specs of a JAX-layout parameter tree (JAX
    ``param_specs`` :176): one axis-name tuple per leaf."""
    return _map_tree(lambda p, leaf: _spec_for_path("/".join(p), leaf.ndim),
                     params)


def fsdp_param_specs(params, n_data: int, min_size: int = 2 ** 16) -> dict:
    """FSDP specs (JAX :196): each leaf of at least ``min_size`` elements
    shards its largest data-divisible axis over ``data``; smaller leaves
    and leaves with no divisible axis stay replicated."""

    def spec_for(_path, leaf):
        if math.prod(leaf.shape) < min_size:
            return ()
        dims = [(d, i) for i, d in enumerate(leaf.shape) if d % n_data == 0]
        if not dims:
            return ()
        _, axis = max(dims)
        return tuple(DATA_AXIS if i == axis else None
                     for i in range(leaf.ndim))

    return _map_tree(spec_for, params)


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


_QKV = re.compile(r".*attn/qkv/(kernel|bias)$")


def head_major_index(width: int, n: int, r: int) -> torch.Tensor:
    """The columns of a fused ``[q | k | v]`` dimension of ``width`` = 3D
    that model rank ``r`` of ``n`` holds: its D/n columns of each of q, k
    and v, in that order.  Its heads' projection is then the fused ``[B,
    T, 3 D/n]`` stream kernel 8 takes at H/n heads, with no shuffle of
    the activations (JAX relabels the activations instead,
    ``ops/attention.py::_head_major_relayout`` :748)."""
    d = width // 3
    dl = d // n
    base = torch.arange(r * dl, (r + 1) * dl)
    return torch.cat([base, base + d, base + 2 * d])


class ParamLayout:
    """Where each leaf of a flattened parameter tree lives over ``mesh``:
    ``specs[i]`` names, per dimension, the mesh axis it is split over
    (None: whole).  A split dimension holds the rank's contiguous chunk,
    except the model split of a fused qkv leaf, which holds the rank's
    heads (:func:`head_major_index`)."""

    def __init__(self, mesh, paths, specs):
        self.mesh = mesh
        self.paths = [tuple(p) for p in paths]
        self.specs = [tuple(s) for s in specs]
        self.sizes = axis_sizes(mesh)
        self.head_major = [
            bool(_QKV.match("/".join(map(str, p)))) and MODEL_AXIS in s
            for p, s in zip(self.paths, self.specs)]

    def axes(self, i: int) -> tuple:
        """The mesh axes leaf ``i`` is split over."""
        return tuple(a for a in self.specs[i] if a is not None)

    def shard(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf ``i``'s full value (a copy)."""
        x = full
        for dim, axis in enumerate(self.specs[i]):
            if axis is None:
                continue
            n, r = self.sizes[axis], axis_rank(self.mesh, axis)
            if self.head_major[i] and axis == MODEL_AXIS:
                idx = head_major_index(x.shape[dim], n, r).to(x.device)
                x = x.index_select(dim, idx)
            else:
                per = x.shape[dim] // n
                x = x.narrow(dim, r * per, per)
        return x.clone(memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor, i: int, axes=None, *,
               differentiable: bool = False) -> torch.Tensor:
        """Leaf ``i``'s value gathered over ``axes`` (every axis it is
        split over by default: the full leaf) from every rank's slice, a
        collective over those axes that every rank calls in one order.
        ``differentiable``: the FSDP gather, whose backward
        reduce-scatters the cotangent (``collectives.fsdp_gather``; not
        for the model axis's head-major split)."""
        from .collectives import fsdp_gather, gather_dim
        x = local if differentiable else local.detach()
        for dim, axis in enumerate(self.specs[i]):
            if axis is None or (axes is not None and axis not in axes):
                continue
            group = self.mesh.get_group(axis)
            if differentiable:
                x = fsdp_gather(x, group, dim)
                continue
            x = gather_dim(x, group, dim)
            if self.head_major[i] and axis == MODEL_AXIS:
                n = self.sizes[axis]
                order = torch.cat([head_major_index(x.shape[dim], n, r)
                                   for r in range(n)]).to(x.device)
                full = torch.empty_like(x)
                full.index_copy_(dim, order, x)
                x = full
        return x

    def gather_list(self, tensors, axes=None, *,
                    differentiable: bool = False) -> list:
        """:meth:`gather` of each leaf in order."""
        return [self.gather(t, i, axes, differentiable=differentiable)
                for i, t in enumerate(tensors)]

    def gather_tree(self, tree, axes=None, *, differentiable: bool = False):
        """The tree (this layout's structure) with :meth:`gather_list`'s
        leaves."""
        leaves, paths = tree_flatten(tree)
        return tree_unflatten(paths, self.gather_list(
            leaves, axes, differentiable=differentiable))

    def norm_f32(self, tensors) -> torch.Tensor:
        """The global L2 norm of tensors in this layout, each element
        counted once: a split leaf's squares are summed over the axes it
        is split over, a replicated leaf's counted as they are.  Squares
        summed in f32; a collective every rank calls in one order."""
        import torch.distributed as dist
        by_axes: dict = {}
        for i, t in enumerate(tensors):
            sq = t.float().square().sum()
            key = self.axes(i)
            by_axes[key] = by_axes.get(key, 0) + sq
        total = torch.zeros((), dtype=torch.float32,
                            device=tensors[0].device)
        for key in sorted(by_axes, key=str):
            part = by_axes[key].reshape(1).clone()
            for axis in key:
                dist.all_reduce(part, group=self.mesh.get_group(axis))
            total = total + part[0]
        return torch.sqrt(total)


def _divides(leaf_shape, spec, sizes) -> bool:
    return all(a is None or leaf_shape[d] % sizes.get(a, 1) == 0
               for d, a in enumerate(spec))


def tp_specs(paths, leaves, mesh, num_heads: Optional[int] = None) -> list:
    """Megatron specs of flattened leaves over ``mesh``'s model axis:
    :func:`param_specs`'s rules, a leaf replicated where its split
    dimension does not divide by the axis, and the attention's qkv and
    proj replicated where the heads do not (``num_heads % model``): that
    layer then computes every head on every rank, the dense result of
    JAX's fallback (``ops/attention.py:732``)."""
    sizes = axis_sizes(mesh)
    n = sizes.get(MODEL_AXIS, 1)
    out = []
    for path, leaf in zip(paths, leaves):
        name = "/".join(map(str, path))
        spec = _spec_for_path(name, leaf.ndim) if n > 1 else ()
        if spec and "/attn/" in f"/{name}" and num_heads and num_heads % n:
            spec = ()
        if spec and not _divides(leaf.shape, spec, sizes):
            spec = ()
        out.append(spec or (None,) * leaf.ndim)
    return out


def tp_layout(params, mesh, num_heads: Optional[int] = None) -> ParamLayout:
    """:class:`ParamLayout` of a JAX-layout tree under tensor parallelism
    (:func:`tp_specs`)."""
    leaves, paths = tree_flatten(params)
    return ParamLayout(mesh, paths, tp_specs(paths, leaves, mesh,
                                             num_heads))


def fsdp_layout(params, mesh, min_size: int = 2 ** 16) -> ParamLayout:
    """:class:`ParamLayout` of a JAX-layout tree under FSDP
    (:func:`fsdp_param_specs` over the mesh's data axis)."""
    leaves, paths = tree_flatten(params)
    specs = tree_flatten(fsdp_param_specs(
        params, axis_sizes(mesh).get(DATA_AXIS, 1), min_size))[0]
    return ParamLayout(mesh, paths, [s or (None,) * leaf.ndim
                                     for s, leaf in zip(specs, leaves)])


def _local_tree(params, layout: ParamLayout) -> dict:
    leaves, paths = tree_flatten(params)
    return tree_unflatten(paths, [layout.shard(_as_tensor(x), i)
                              for i, x in enumerate(leaves)])


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np
    return torch.as_tensor(np.asarray(x))


def shard_params(params, mesh, num_heads: Optional[int] = None):
    """The parameters laid out over ``mesh`` (JAX :184): on a mesh without
    a model axis every rank holds the whole tree, broadcast from rank 0 in
    place; with a model axis larger than 1 each rank gets its Megatron
    slices (:func:`tp_specs`; ``num_heads`` keeps the attention whole
    where the heads do not divide), a new tree of this rank's leaves."""
    if axis_sizes(mesh).get(MODEL_AXIS, 1) > 1:
        return _local_tree(params, tp_layout(params, mesh, num_heads))
    from .collectives import broadcast_params
    broadcast_params(tree_flatten(params)[0])
    return params


def shard_params_fsdp(params, mesh, min_size: int = 2 ** 16):
    """The FSDP layout (JAX :194): each leaf of at least ``min_size``
    elements keeps this rank's chunk of its largest data-divisible axis
    (:func:`fsdp_param_specs`); smaller leaves stay whole.  Returns a new
    tree of this rank's leaves."""
    return _local_tree(params, fsdp_layout(params, mesh, min_size))


def module_tp_state(module, mesh) -> dict:
    """A port ViT module's state dict with each encoder layer's Megatron
    slices for this rank of ``mesh``'s model axis (the module path's
    tensor-parallel eval over full weights): qkv's heads and fc1's columns
    (``nn.Linear`` rows), proj's and fc2's input columns.  A layer whose
    heads or hidden width do not divide keeps that half whole."""
    from ..models.vit import Attention, MlpBlock
    n = axis_sizes(mesh).get(MODEL_AXIS, 1)
    r = axis_rank(mesh, MODEL_AXIS)
    sd = dict(module.state_dict())
    for name, mod in module.named_modules():
        if isinstance(mod, Attention) and mod.num_heads % n == 0:
            idx = head_major_index(mod.qkv.weight.shape[0], n, r)
            sd[f"{name}.qkv.weight"] = mod.qkv.weight.detach()[
                idx.to(mod.qkv.weight.device)]
            sd[f"{name}.qkv.bias"] = mod.qkv.bias.detach()[
                idx.to(mod.qkv.bias.device)]
            per = mod.proj.weight.shape[1] // n
            sd[f"{name}.proj.weight"] = mod.proj.weight.detach()[
                :, r * per:(r + 1) * per].contiguous()
        elif isinstance(mod, MlpBlock) and mod.fc1.weight.shape[0] % n == 0:
            per = mod.fc1.weight.shape[0] // n
            sl = slice(r * per, (r + 1) * per)
            sd[f"{name}.fc1.weight"] = mod.fc1.weight.detach()[sl]
            sd[f"{name}.fc1.bias"] = mod.fc1.bias.detach()[sl]
            sd[f"{name}.fc2.weight"] = mod.fc2.weight.detach()[
                :, sl].contiguous()
    return sd
