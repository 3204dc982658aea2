"""The collectives of the port's parallel paths, with their gradients
(what the JAX package gets from XLA: the ``all_gather`` inside
``_sp_sharded`` and its transpose, GSPMD's gradient all-reduce and the
Megatron and FSDP collectives it derives from the specs, the pipeline's
``ppermute`` and masked ``psum``).

- :func:`all_gather_seq`: the sequence group's blocks of a ``[B, Tl, C]``
  tensor gathered along dim 1 into ``[B, n Tl, C]``; its backward is the
  reduce-scatter (sum) of the cotangent, in the tensor's dtype, the
  transpose of JAX's ``all_gather(tiled=True)`` (``psum_scatter``): a
  bf16 dKV is summed in bf16.
- :func:`gather_rows`: the data group's row blocks gathered along dim 0;
  its backward keeps the rank's own rows of the cotangent.  Every rank
  computes the same loss on the gathered rows, so each rank's gradient is
  its own rows' share and the shares sum to the global gradient.
- :func:`from_rank` (:func:`from_seq_rank0`): one rank's tensor on every
  rank of the group; its gradient stays on that rank (zero elsewhere), so
  a quantity computed on every rank from it counts once.  The pipeline
  takes its last stage's outputs to every stage with it (JAX's masked
  ``psum``, ``parallel/pipeline.py`` :225).
- :func:`psum`: the group's sum of a tensor on every rank; its backward
  is the sum of the cotangents (JAX's ``psum`` transpose), so a quantity
  that flows back on one rank only (a :func:`from_rank` result)
  reaches every rank's share.  The mean pooling under a seq axis sums
  each rank's tokens with it.
- Megatron's two operators on the model group: :func:`copy_to_group`
  (identity forward, the backward all-reduces the cotangent: at the input
  of a column-split product, whose rank computes only its columns' share
  of the input's gradient) and :func:`reduce_from_group` (the forward
  all-reduces the row-split product's partial sums, the backward is the
  identity).  :func:`copy_to_group` over the pipe group also gives every
  stage the embedding's gradient, which only stage 0's pipeline input
  has.
- :func:`fsdp_gather`: an FSDP leaf's chunks gathered along its split
  dimension over the data group; its backward reduce-scatters (sums) the
  cotangent, so each rank gets the global gradient of its own chunk and
  the gradients and Adam moments stay sharded.
- :func:`send_to` / :func:`recv_from`: the pipeline's hop to the next
  stage (its backward hops back to the previous one), JAX's
  ``ppermute``.  Under NCCL a tensor is sent from the card; under gloo,
  whose point-to-point calls take CPU tensors only, it goes through host
  memory.  The group's backend picks the path.
- :func:`all_reduce_sum` (a gradient all-reduce over a group, one flat
  buffer), :func:`all_gather_rows` and :func:`gather_dim` (no
  gradient) and :func:`broadcast_params`.

Each runs on the group's own backend with the same calls: NCCL across
cards, and gloo, which ``chip_smoke.py`` uses to run several ranks on one
card (NCCL refuses two ranks on one GPU) and the CPU tests use; gloo
takes CUDA tensors for every collective here
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
``broadcast``, in f32 and bf16).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """``[n * rows, ...]``: the group's ``x`` stacked along dim 0 in rank
    order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x [n * rows, ...]``, this rank's rows."""
    x = x.contiguous()
    rows = x.shape[0] // dist.get_world_size(group)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        full = _gather0(x.transpose(0, 1), group)          # [n Tl, B, C]
        return full.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        part = _reduce_scatter0(g.transpose(0, 1), ctx.group)
        return part.transpose(0, 1).contiguous(), None


def all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``x [B, Tl, C]`` of each rank of ``group`` -> ``[B, n Tl, C]``, the
    blocks in rank order; differentiable (the backward reduce-scatters)."""
    return _AllGatherSeq.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.rank = x.shape[0], dist.get_rank(group)
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x [rows, ...]`` of each rank of ``group`` -> ``[n rows, ...]`` in
    rank order, differentiable for a quantity that every rank computes
    alike from the result (the backward keeps this rank's rows)."""
    return _GatherRows.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_rows` without a gradient (labels, scores), where the
    ranks may hold different row counts."""
    x = x.detach().contiguous()
    counts = _gather0(torch.tensor([x.shape[0]], device=x.device),
                      group).tolist()
    most = max(counts)
    if x.shape[0] < most:
        x = torch.cat([x, x.new_zeros((most - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    full = _gather0(x, group)
    return torch.cat([full[i * most:i * most + c]
                      for i, c in enumerate(counts)])


class _FromRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.mine = dist.get_rank(group) == src
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=dist.get_global_rank(group, src),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def from_rank(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (same shape
    everywhere); the gradient flows back on ``src`` only."""
    return _FromRank.apply(x, group, src)


def from_seq_rank0(x: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of ``group`` (same shape everywhere);
    the gradient flows back on rank 0 only."""
    return _FromRank.apply(x, group, 0)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on each of them;
    differentiable (the backward sums the cotangents over the group)."""
    return _Psum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is the sum of the group's cotangents
    (Megatron's ``f``)."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` on every rank, in ``x.dtype``; the gradient
    passes through unchanged (Megatron's ``g``)."""
    return _ReduceFromGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's chunks of ``x`` concatenated along ``dim`` in rank
    order (no gradient)."""
    full = _gather0(x.detach().movedim(dim, 0), group)
    return full.movedim(0, dim).contiguous()


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        part = _reduce_scatter0(g.movedim(ctx.dim, 0), ctx.group)
        return part.movedim(0, ctx.dim).contiguous(), None, None


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The full leaf from the group's chunks of it along ``dim``;
    differentiable (the backward reduce-scatters the cotangent: this
    rank's chunk of the group's summed gradient)."""
    return _FsdpGather.apply(x, group, dim)


def _via_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send_to(x: torch.Tensor, group, dst: int):
    """Start sending ``x`` to group rank ``dst``; returns the work to wait
    on (the send buffer lives in it until then)."""
    buf = x.detach().contiguous()
    if _via_host(group, buf):
        buf = buf.cpu()
    work = dist.isend(buf, dst=dist.get_global_rank(group, dst), group=group)
    return work, buf


def recv_from(shape, dtype, device, group, src: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from group rank
    ``src`` onto ``device``."""
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(device) if host else buf


def all_reduce_sum(tensors, group=None):
    """Sum each tensor over ``group`` (the whole world by default) in
    place, through one flat buffer per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
    return tensors


def broadcast_params(tensors, src: int = 0):
    """Overwrite each tensor in place with rank ``src``'s (every rank
    starts from the same parameters)."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src)
    return tensors
