"""Deterministic row scatter-add (the backward of a row gather).

Port of ``bodyfitting_tpu.ops.pallas_kernels.rows_scatter_add`` (kernel
``_rows_scatter_kernel``, pallas_kernels.py:1738); the CUDA kernel is
``ops/csrc/rows_scatter.cu``.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

MAX_M = 2 ** 22 - 1     # the kernel's sort key is idx << 10 | p, 32 bits


def rows_scatter_add_plain(idx: torch.Tensor, g: torch.Tensor,
                           M: int) -> torch.Tensor:
    """PyTorch version of :func:`rows_scatter_add` (any dtype/device), with
    the kernel's summation order on every device: each ``out[bv, :, m]``
    starts at 0 and adds its entries in ascending ``p``.

    The kept entries are stably sorted by their output row, which ranks
    each within its row in ascending ``p``; then rank ``r`` is added onto
    the output at once.  No row repeats inside a rank, so no addition
    races with another (``scatter_add_`` on the card takes atomics, whose
    order changes from run to run)."""
    BV, _, C = g.shape
    keep = ((idx >= 0) & (idx < M)).reshape(-1)
    row = (idx.long() + M * torch.arange(BV, device=idx.device)[:, None])
    row = row.reshape(-1)[keep]
    vals = g.reshape(-1, C)[keep]
    out = g.new_zeros((BV * M, C))
    if row.numel():
        row, order = torch.sort(row, stable=True)
        vals = vals[order]
        pos = torch.arange(row.numel(), device=row.device)
        head = torch.ones_like(row, dtype=torch.bool)
        head[1:] = row[1:] != row[:-1]
        rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
        rank, by_rank = torch.sort(rank, stable=True)
        row, vals = row[by_rank], vals[by_rank]
        start = 0
        for n in torch.bincount(rank).tolist():
            r = row[start:start + n]
            out[r] = out[r] + vals[start:start + n]
            start += n
    return out.reshape(BV, M, C).transpose(1, 2).contiguous()


def rows_scatter_add(idx: torch.Tensor, g: torch.Tensor,
                     M: int) -> torch.Tensor:
    """``out[bv, c, m] = sum over p with idx[bv, p] == m of g[bv, p, c]``.

    idx ``[BV, P]`` int32 (entries ``>= M`` or ``< 0`` are dropped);
    g ``[BV, P, 2]`` (the x/y cotangent of the ICP match; other widths
    raise).  Returns ``[BV, C, M]`` (the JAX
    ``[C, M]`` layout per batch row).  Both the kernel and the plain
    version sum in ascending ``p`` from 0 without float atomics, so they
    agree bitwise and repeated launches are bitwise equal.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    anything else raises.
    """
    if g.dim() != 3 or idx.shape != g.shape[:2] or g.shape[2] != 2:
        raise ValueError(f"rows_scatter_add: idx {tuple(idx.shape)} and g "
                         f"{tuple(g.shape)} must be [BV, P] and [BV, P, 2]")
    if _build.on_cpu(idx, g):
        return rows_scatter_add_plain(idx, g, M)
    _build.require("rows_scatter_add idx", idx, torch.int32, 2)
    _build.require("rows_scatter_add g", g, torch.float32, 3)
    BV, P, C = g.shape
    if M >= MAX_M:
        raise ValueError(f"rows_scatter_add: M {M} must be below {MAX_M} "
                         f"(the kernel packs idx into a 22-bit key)")
    out = torch.empty((BV, C, M), dtype=torch.float32, device=g.device)
    _build.launch(
        "rows_scatter", "rows_scatter_add_f32", g.device,
        [idx.data_ptr(), g.data_ptr(), out.data_ptr()], [BV, P, M],
    )
    rows_scatter_add.launches += 1
    return out


rows_scatter_add.launches = 0


def launch_geometry(BV: int, P: int, M: int) -> dict:
    """The kernel's launch geometry at these sizes (builds it if needed):
    ``{"blocks", "threads", "smem_bytes"}``."""
    return _build.geometry("rows_scatter", "rows_scatter_add_geometry",
                           [BV, P, M])
