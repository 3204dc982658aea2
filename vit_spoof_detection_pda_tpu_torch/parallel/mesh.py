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
  the gradients are all-reduced, ``parallel/collectives.py``).  A model
  axis larger than 1 (Megatron TP), FSDP and the pipeline are ROADMAP
  Queue 1 item 9b and raise where they would run.

The Megatron and FSDP rule tables (:func:`param_specs`,
:func:`fsdp_param_specs`) are kept as data over the JAX-layout parameter
tree, each spec an axis-name tuple (``()`` replicated, ``(None,
"model")`` a column split).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

_ITEM_9B = "ROADMAP Queue 1 item 9b"


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
    raise ``ValueError`` on layouts that cannot compose, and
    ``NotImplementedError`` for the pipeline (item 9b).  Returns
    ``(data, model, seq)``."""
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
    if pipe > 1:
        raise NotImplementedError(
            f"sharding.pipeline_parallel={pipe} (the GPipe schedule, "
            f"parallel/pipeline.py) is not ported: {_ITEM_9B}")
    return data, model, seq


def config_layout(sharding_cfg, n: Optional[int] = None) -> dict:
    """``{axis name: size}`` of the mesh :func:`mesh_from_config` builds
    over ``n`` ranks (the process group's by default): ``seq_parallel >
    1`` -> (data, seq), otherwise (data, model); ``data_parallel = -1``
    takes the remaining ranks."""
    data, model, seq = check_sharding(sharding_cfg)
    n = world_size() if n is None else n
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
# pattern (JAX :145).  Training under them is item 9b.
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
        if leaf.numel() < min_size:
            return ()
        dims = [(d, i) for i, d in enumerate(leaf.shape) if d % n_data == 0]
        if not dims:
            return ()
        _, axis = max(dims)
        return tuple(DATA_AXIS if i == axis else None
                     for i in range(leaf.ndim))

    return _map_tree(spec_for, params)


def shard_params(params, mesh):
    """The parameters replicated on every rank of ``mesh``: each leaf
    broadcast from rank 0 in place (the JAX ``shard_params`` of a mesh
    without a model axis).  A model axis larger than 1 raises (item
    9b)."""
    if axis_sizes(mesh).get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            f"tensor-parallel parameter layouts (a model axis > 1) are not "
            f"ported: {_ITEM_9B}")
    from .collectives import broadcast_params
    leaves = []
    _map_tree(lambda _p, leaf: leaves.append(leaf), params)
    broadcast_params(leaves)
    return params


def shard_params_fsdp(params, mesh, min_size: int = 2 ** 16):
    """FSDP parameter layout (FSDP2): not ported (item 9b)."""
    raise NotImplementedError(
        f"FSDP (sharding.fsdp) is not ported: {_ITEM_9B}")
