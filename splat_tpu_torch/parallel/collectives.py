"""Differentiable exchanges over `torch.distributed` for the sharded loss.

The convention every function here keeps: **each rank back-propagates its
own share of the loss, and the shares of all ranks sum to the single-device
loss.** A collective's backward therefore hands each rank the sum of every
rank's cotangent for the values it contributed:

  * `all_reduce_sum`: forward the sum over the axis, backward the sum of the
    cotangents (an all-reduce);
  * `all_gather`: forward every rank's tensor stacked along a new leading
    axis, backward each rank's slice of the summed cotangent (a
    reduce-scatter; gloo has none, so there an all-reduce and a slice);
  * `all_to_all`: forward block j of rank i goes to block i of rank j,
    backward the inverse exchange, which is the same one;
  * `from_next`: forward rank i receives `hop` ranks down the axis, the last
    ranks zeros; backward the cotangent goes back to the rank that sent.

So a term that several ranks compute identically is divided by their count
(or added on one of them only) before `backward`, and after `backward` a
leaf's gradient is summed over the ranks that hold the same leaf
(`sharding.reduce_gradients`).

An `Axis` of size 1 needs no exchange: every function returns its input
(stacked for `all_gather`) without touching `torch.distributed`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it, the global ranks along it in axis order, and their
    process group (None when the size is 1)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = None


def reduce_(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a tensor that carries no gradient."""
    if axis.size > 1:
        dist.all_reduce(x, op=op, group=axis.group)
    return x


def gather_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size, *x.shape): every rank's x, no gradient."""
    if axis.size == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.stack(parts)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return reduce_(x.detach().clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_(g.clone(memory_format=torch.contiguous_format), ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return gather_(x.detach(), axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        g = g.contiguous()
        if dist.get_backend(axis.group) == "nccl":
            out = torch.empty_like(g[0])
            dist.reduce_scatter_tensor(out, g, group=axis.group)
            return out, None
        return reduce_(g.clone(), axis)[axis.index].clone(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.detach().contiguous(), group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.axis.group)
        return out, None


def _shift(x: torch.Tensor, axis: Axis, hop: int) -> torch.Tensor:
    """Rank i gets x of rank i + hop, zeros where that rank is off the axis
    (hop < 0: from the ranks before): each rank sends to i - hop and
    receives from i + hop in one batch of point-to-point operations."""
    out = torch.zeros_like(x)
    ops = []
    if 0 <= axis.index - hop < axis.size:
        ops.append(dist.P2POp(dist.isend, x, axis.ranks[axis.index - hop]))
    if 0 <= axis.index + hop < axis.size:
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[axis.index + hop]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _FromNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, hop):
        ctx.axis, ctx.hop = axis, hop
        return _shift(x.detach().contiguous(), axis, hop)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.axis, -ctx.hop), None, None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of x over the axis, on every rank of it."""
    return x if axis.size == 1 else _AllReduceSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's x in axis order."""
    return x[None] if axis.size == 1 else _AllGather.apply(x, axis)


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x (axis.size, ...): block j goes to rank j, which holds it as block i
    (i this rank's index)."""
    return x if axis.size == 1 else _AllToAll.apply(x, axis)


def from_next(x: torch.Tensor, axis: Axis, hop: int = 1) -> torch.Tensor:
    """x of the rank `hop` further along the axis; zeros on the last `hop`."""
    if axis.size == 1 or hop >= axis.size:
        return torch.zeros_like(x)
    return _FromNext.apply(x, axis, hop)
