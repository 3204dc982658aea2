"""The collectives of the port's data- and sequence-parallel paths, with
their gradients (what the JAX package gets from XLA: the ``all_gather``
inside ``_sp_sharded`` and its transpose, GSPMD's gradient all-reduce).

- :func:`all_gather_seq`: the sequence group's blocks of a ``[B, Tl, C]``
  tensor gathered along dim 1 into ``[B, n Tl, C]``; its backward is the
  reduce-scatter (sum) of the cotangent, in the tensor's dtype, the
  transpose of JAX's ``all_gather(tiled=True)`` (``psum_scatter``): a
  bf16 dKV is summed in bf16.
- :func:`gather_rows`: the data group's row blocks gathered along dim 0;
  its backward keeps the rank's own rows of the cotangent.  Every rank
  computes the same loss on the gathered rows, so each rank's gradient is
  its own rows' share and the shares sum to the global gradient.
- :func:`from_seq_rank0`: seq rank 0's tensor on every rank of the
  sequence group; its gradient stays on seq rank 0 (zero elsewhere), so a
  quantity computed on every rank from it counts once.
- :func:`psum`: the group's sum of a tensor on every rank; its backward
  is the sum of the cotangents (JAX's ``psum`` transpose), so a quantity
  that flows back on one rank only (a :func:`from_seq_rank0` result)
  reaches every rank's share.  The mean pooling under a seq axis sums
  each rank's tokens with it.
- :func:`all_reduce_sum` (the gradient all-reduce over the whole data x
  seq group, one flat buffer), :func:`all_gather_rows` (no gradient) and
  :func:`broadcast_params`.

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


class _FromSeqRank0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.first = dist.get_rank(group) == 0
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def from_seq_rank0(x: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of ``group`` (same shape everywhere);
    the gradient flows back on rank 0 only."""
    return _FromSeqRank0.apply(x, group)


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
