"""The collectives of the port's data and tensor parallelism, as functions
that autograd differentiates.

Megatron's two region functions:

  - :func:`copy_to_model`: identity forward, sum over the group backward (the
    input of a column-split layer: each rank's heads contribute a share of
    the input's gradient);
  - :func:`sum_from_model`: sum over the group forward, identity backward
    (the partial products of a row-split layer; every rank then holds the
    same sum, and each backpropagates it into its own shard).

Each takes a process group, or None for a single process, where both are
the identity. Besides: :func:`all_reduce_sum_` sums tensors in place through
one flat buffer (the data-parallel gradient sum), :func:`gather_rows` puts
the ranks' row blocks back into the global batch, and
:func:`broadcast_row` hands one row from the rank that holds it to the
others.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _sum(x, group):
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


class _SumFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, group)
    return x


def sum_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; the gradient passed through
    unchanged backward."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumFromModel.apply(x, group)
    return _sum(x.contiguous(), group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group`` in place, through one flat
    float32 buffer and one collective. A no-op for group None."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    start = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[start:start + n].view_as(t))
        start += n


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from each data rank's block of rows ``x`` (equal
    blocks), in the mesh's data order. The identity without a group."""
    group = mesh.data_group
    if group is None:
        return x
    ranks = sorted(mesh.group_ranks(mesh.data_axes))
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x.contiguous(), group=group)
    order = sorted(range(len(ranks)), key=lambda i: mesh.data_index(ranks[i]))
    return torch.cat([parts[i] for i in order], dim=0)


def broadcast_row(row: Optional[torch.Tensor], like: torch.Tensor, global_row: int,
                  per_rank: int, mesh) -> torch.Tensor:
    """Row ``global_row`` of the global batch on every data rank: ``row`` on
    the rank whose block holds it (None elsewhere), sent from there over the
    data group. ``like`` gives the row's shape, dtype and device."""
    group = mesh.data_group
    if group is None:
        return row
    peers = mesh.group_ranks(mesh.data_axes)
    src = next(r for r in peers if mesh.data_index(r) == global_row // per_rank)
    buf = row.contiguous().clone() if mesh.rank == src else torch.empty_like(like)
    dist.broadcast(buf, src=src, group=group)
    return buf
