"""Row gathers and scatter-sums whose sums run in a fixed order.

``table[idx]`` has a backward that adds the cotangent rows sharing an
index, and ``out.index_add(0, idx, src)`` adds the source rows sharing
one.  On a CUDA device PyTorch does both with float atomics, so the
order of the additions, and with it the last bits of the sum, changes
from run to run.  A fit that amplifies rounding (SMPL+D's displacement
stage, ~1.6x a step) then ends somewhere else on every run.

Here a :class:`RowIndex` holds ``idx`` with the order that sorts it
stably (each row's positions in ascending order) and each row's count.
The scatter-sum becomes a gather into that order and one
``segment_reduce``, which adds each row's entries one after another from
zero, as a sequential ``index_add`` does; the gather's backward is that
scatter-sum.  No atomics: the same bits on every run, and on the CPU and
a CUDA device alike.  Build the index once for a fixed ``idx`` (a mesh's
faces) and reuse it: :func:`cached_row_index`.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch


@dataclasses.dataclass(frozen=True)
class RowIndex:
    idx: torch.Tensor        # [N] int64, values in [0, rows)
    order: torch.Tensor      # [N] positions of idx sorted stably by row
    counts: torch.Tensor     # [rows] entries of each row
    rows: int


def row_index(idx: torch.Tensor, rows: int) -> RowIndex:
    """The :class:`RowIndex` of ``idx`` (any shape, flattened) over
    ``rows`` rows."""
    idx = idx.reshape(-1).long().clone()     # holds no view of the caller's
    order = torch.sort(idx, stable=True).indices
    return RowIndex(idx=idx, order=order,
                    counts=torch.bincount(idx, minlength=rows), rows=rows)


_CACHE: dict = {}


def cached_row_index(idx: torch.Tensor, rows: int,
                     transpose: bool = False) -> RowIndex:
    """:func:`row_index` of ``idx`` (of ``idx.T`` with ``transpose``),
    kept for as long as the tensor ``idx`` lives (keyed by the tensor
    object: do not modify it in place)."""
    key = (id(idx), rows, transpose)
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is idx:
        return hit[1]
    index = row_index(idx.T if transpose else idx, rows)
    _CACHE[key] = (weakref.ref(idx), index)
    weakref.finalize(idx, _CACHE.pop, key, None)
    return index


def _sum_by_inverse(src: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """``out[r] = sum of src[p] over idx[p] == r``, added one position
    at a time in ascending ``p``."""
    return torch.segment_reduce(src[index.order], "sum",
                                lengths=index.counts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index):
        ctx.index = index
        return table[index.idx]

    @staticmethod
    def backward(ctx, grad):
        return _sum_by_inverse(grad, ctx.index), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, index):
        ctx.index = index
        return _sum_by_inverse(src, index)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index.idx], None


def gather_rows(table: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """``table[index.idx]`` (``[N, ...]``), its backward summed in a
    fixed order."""
    return _GatherRows.apply(table, index)


def scatter_rows(src: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """The rows of ``src [N, ...]`` summed onto ``index.rows`` rows by
    ``index.idx``, each in ascending position: ``zeros.index_add(0, idx,
    src)`` in a fixed order."""
    return _ScatterRows.apply(src, index)
