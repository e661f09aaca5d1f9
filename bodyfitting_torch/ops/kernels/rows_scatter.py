"""Deterministic row scatter-add (the backward of a row gather).

Port of ``bodyfitting_tpu.ops.pallas_kernels.rows_scatter_add`` (kernel
``_rows_scatter_kernel``, pallas_kernels.py:1738); the CUDA kernel is
``ops/csrc/rows_scatter.cu``.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build


def rows_scatter_add_plain(idx: torch.Tensor, g: torch.Tensor,
                           M: int) -> torch.Tensor:
    """PyTorch version of :func:`rows_scatter_add` (any dtype/device)."""
    BV, P, C = g.shape
    keep = (idx >= 0) & (idx < M)
    safe = torch.where(keep, idx, 0).long()
    gk = torch.where(keep[..., None], g, 0.0)
    out = g.new_zeros((BV, C, M))
    out.scatter_add_(2, safe[:, None, :].expand(BV, C, P), gk.transpose(1, 2))
    return out


def rows_scatter_add(idx: torch.Tensor, g: torch.Tensor,
                     M: int) -> torch.Tensor:
    """``out[bv, c, m] = sum over p with idx[bv, p] == m of g[bv, p, c]``.

    idx ``[BV, P]`` int32 (entries ``>= M`` or ``< 0`` are dropped);
    g ``[BV, P, 2]`` (the x/y cotangent of the ICP match; other widths
    raise).  Returns ``[BV, C, M]`` (the JAX
    ``[C, M]`` layout per batch row).  The CUDA kernel sums in ascending
    ``p`` without atomics, so repeated launches are bitwise equal.

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
    out = torch.empty((BV, C, M), dtype=torch.float32, device=g.device)
    _build.launch(
        "rows_scatter", "rows_scatter_add_f32", g.device,
        [idx.data_ptr(), g.data_ptr(), out.data_ptr()], [BV, P, M],
    )
    rows_scatter_add.launches += 1
    return out


rows_scatter_add.launches = 0
