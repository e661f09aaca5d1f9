"""Contour -> projected-vertex nearest match with payloads.

Port of ``bodyfitting_tpu.ops.pallas_kernels.contour_match_full``
(kernel ``_contour_match_full_kernel``, pallas_kernels.py:1620) and of
``contour_min_idx`` (:1157), which is the same match without payloads and
is served here by the same CUDA kernel (``ops/csrc/contour_match.cu``).
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

FAR = 1e30


def contour_match_full_plain(contour, proj, valid, inside):
    """PyTorch version of :func:`contour_match_full` (any dtype/device).

    The kernel's sequential strict-``<`` scan started at ``FAR`` picks the
    first index of the row minimum when that minimum is below ``FAR``,
    and otherwise keeps its start value (idx 0, matched (0, 0), inside 0).
    NaN distances never win.
    """
    big = torch.where(valid > 0, proj.new_zeros(()), proj.new_full((), FAR))
    dx = contour[..., 0:1] - proj[..., 0][:, None, :]
    dy = contour[..., 1:2] - proj[..., 1][:, None, :]
    d2 = dx * dx + dy * dy + big[:, None, :]                  # [BV, P, M]
    d2 = torch.where(torch.isnan(d2), float("inf"), d2)
    mind, arg = torch.min(d2, dim=-1)
    hit = mind < FAR
    arg = torch.where(hit, arg, 0)
    matched = torch.gather(proj, 1, arg[..., None].expand(-1, -1, 2))
    matched = torch.where(hit[..., None], matched, 0.0)
    in_match = torch.where(hit, torch.gather(inside, 1, arg), 0.0)
    d2_out = torch.where(hit, mind, FAR)
    return d2_out, arg.to(torch.int32), matched, in_match


def contour_match_full(contour: torch.Tensor, proj: torch.Tensor,
                       valid: torch.Tensor, inside: torch.Tensor):
    """Nearest valid projected vertex per contour pixel, with payloads.

    contour ``[BV, P, 2]``; proj ``[BV, M, 2]``; valid, inside ``[BV, M]``
    (a candidate is valid when ``valid > 0``).  Returns ``(d2 [BV, P],
    idx [BV, P] int32, matched [BV, P, 2], in_match [BV, P])``.  Ties keep
    the lowest index; a row with no valid candidate returns
    ``(1e30, 0, (0, 0), 0)``.  Not differentiable: callers stop gradients
    and route them through :func:`rows_scatter_add`.

    CPU tensors take the plain version; CUDA tensors (contiguous f32)
    launch the kernel, anything else raises.
    """
    if _build.on_cpu(contour, proj, valid, inside):
        return contour_match_full_plain(contour, proj, valid, inside)
    f32 = torch.float32
    _build.require("contour_match_full contour", contour, f32, 3)
    _build.require("contour_match_full proj", proj, f32, 3)
    _build.require("contour_match_full valid", valid, f32, 2)
    _build.require("contour_match_full inside", inside, f32, 2)
    BV, P, _ = contour.shape
    M = proj.shape[1]
    if (contour.shape[2] != 2 or proj.shape != (BV, M, 2)
            or valid.shape != (BV, M) or inside.shape != (BV, M)):
        raise ValueError(
            f"contour_match_full shapes {tuple(contour.shape)}, "
            f"{tuple(proj.shape)}, {tuple(valid.shape)}, "
            f"{tuple(inside.shape)} do not agree"
        )
    dev = contour.device
    d2 = torch.empty((BV, P), dtype=f32, device=dev)
    idx = torch.empty((BV, P), dtype=torch.int32, device=dev)
    matched = torch.empty((BV, P, 2), dtype=f32, device=dev)
    in_match = torch.empty((BV, P), dtype=f32, device=dev)
    _build.launch(
        "contour_match", "contour_match_full_f32", dev,
        [contour.data_ptr(), proj.data_ptr(), valid.data_ptr(),
         inside.data_ptr(), d2.data_ptr(), idx.data_ptr(),
         matched.data_ptr(), in_match.data_ptr()],
        [BV, P, M],
    )
    contour_match_full.launches += 1
    return d2, idx, matched, in_match


contour_match_full.launches = 0


def launch_geometry(BV: int, P: int, M: int) -> dict:
    """The kernel's launch geometry at these sizes (builds it if needed):
    ``{"blocks", "threads", "smem_bytes"}``."""
    return _build.geometry("contour_match", "contour_match_full_geometry",
                           [BV, P, M])


def contour_min_idx(contour: torch.Tensor, proj: torch.Tensor,
                    valid: torch.Tensor):
    """:func:`contour_match_full` without payloads: ``(d2, idx)``."""
    d2, idx, _, _ = contour_match_full(contour, proj, valid,
                                       torch.zeros_like(valid))
    return d2, idx
