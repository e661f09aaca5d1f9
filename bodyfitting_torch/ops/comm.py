"""The collectives of the multi-device fits, as autograd Functions.

Every rank of a group computes the same replicated loss, so the stock
autograd collectives (``torch.distributed.nn``) count a loss that each
rank computes in full once per rank, and on gloo their backward fails
on a subgroup.  These three carry the semantics of the SPMD fit:

* :func:`all_gather` — each rank's block, concatenated in rank order on
  every rank; backward: this rank's block of the (replicated) cotangent.
* :func:`sum_over` — the sum of each rank's partial term, on every rank;
  backward: the identity (every rank holds the whole cotangent).
* :func:`copy_to` — the identity on a replicated tensor that enters a
  rank-local term; backward: the sum of the ranks' cotangents, so each
  rank's gradient counts every rank's term once.

A group of one (or ``None``) makes each of them the identity.  While
:data:`LOG` is a list, each collective appends its kind, shape, dtype,
group and the bytes this rank sends to it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

LOG = None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _note(kind, t, group):
    if LOG is not None:
        LOG.append((kind, tuple(t.shape), t.dtype, group,
                    t.numel() * t.element_size()))


def raw_all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim``
    (each rank's ``t`` of one shape); no autograd."""
    t = t.contiguous()
    _note("all_gather", t, group)
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def raw_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor); no autograd."""
    out = t.clone(memory_format=torch.contiguous_format)
    _note("all_reduce", out, group)
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return raw_all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return raw_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return raw_sum(grad, ctx.group), None


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    return _AllGather.apply(t, group, dim)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    return _SumOver.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    return _CopyTo.apply(t, group)
