"""Fused linear blend skinning, forward and backward, batched over frames.

Port of ``bodyfitting_tpu.ops.pallas_kernels.make_fused_skinning``
(kernels ``_skin_fwd_kernel`` :982 and ``_skin_bwd_kernel`` :996); the
CUDA kernels are ``ops/csrc/skinning.cu``.  The JAX function runs one
frame and is ``vmap``ped; here the frame axis ``B`` is explicit and is a
grid axis of the kernels.  The TPU kernel's VMEM vertex tiles have no
counterpart, but the backward's ``dA`` is summed in tiles of
:data:`TILE` vertices, then over tiles in order: that order is the
contract, so the kernel and the plain versions agree bit for bit.

``fused_skinning(W, A, vp)`` is differentiable in ``A`` and ``vp``
(:class:`FusedSkinning`); ``W`` is a constant, as the Pallas closure
makes it.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

TILE = 128      # vertices per dA partial sum (csrc/skinning.cu kTile)
MAX_JOINTS = 64


def _blend(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``T [B, V, 12] = W @ A[b]``, summed over joints in ascending order,
    each product and sum rounded on its own (the kernel's order)."""
    T = W.new_zeros((A.shape[0], W.shape[0], 12))
    for j in range(W.shape[1]):
        T = T + W[None, :, j, None] * A[:, None, j, :]
    return T


def skin_forward_plain(W: torch.Tensor, A: torch.Tensor,
                       vp: torch.Tensor) -> torch.Tensor:
    """PyTorch version of :func:`skin_forward`, in the kernel's order."""
    T = _blend(W, A)
    cols = []
    for r in range(3):
        acc = T[..., 4 * r + 3]
        for k in range(3):
            acc = acc + T[..., 4 * r + k] * vp[..., k]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def skin_backward_plain(W: torch.Tensor, A: torch.Tensor, vp: torch.Tensor,
                        g: torch.Tensor):
    """PyTorch version of :func:`skin_backward`: ``(dA, dvp)`` in the
    kernel's order (``dA`` per tile of :data:`TILE` vertices, then over
    tiles)."""
    B, V, _ = vp.shape
    J = W.shape[1]
    T = _blend(W, A)
    cols = []
    for k in range(3):
        acc = T[..., k] * g[..., 0]
        for r in range(1, 3):
            acc = acc + T[..., 4 * r + k] * g[..., r]
        cols.append(acc)
    dvp = torch.stack(cols, dim=-1)
    blocks = []
    for r in range(3):
        gr = g[..., r]
        blocks += [gr * vp[..., 0], gr * vp[..., 1], gr * vp[..., 2], gr]
    M = torch.stack(blocks, dim=-1)                         # [B, V, 12]
    tiles = -(-V // TILE)
    pad = tiles * TILE - V
    Wt = torch.cat([W, W.new_zeros((pad, J))]).reshape(tiles, TILE, J)
    Mt = torch.cat([M, M.new_zeros((B, pad, 12))], dim=1).reshape(
        B, tiles, TILE, 12)
    part = W.new_zeros((B, tiles, J, 12))
    for i in range(TILE):
        part = part + Wt[None, :, i, :, None] * Mt[:, :, i, None, :]
    dA = W.new_zeros((B, J, 12))
    for s in range(tiles):
        dA = dA + part[:, s]
    return dA, dvp


def _check(W, A, vp):
    if (W.dim() != 2 or A.dim() != 3 or vp.dim() != 3
            or A.shape[1:] != (W.shape[1], 12)
            or vp.shape != (A.shape[0], W.shape[0], 3)):
        raise ValueError(f"skinning: W {tuple(W.shape)}, A {tuple(A.shape)}, "
                         f"vp {tuple(vp.shape)} must be [V, J], [B, J, 12], "
                         f"[B, V, 3]")


def skin_forward(W: torch.Tensor, A: torch.Tensor,
                 vp: torch.Tensor) -> torch.Tensor:
    """``verts [B, V, 3]`` from skinning weights ``W [V, J]``, blended
    transforms ``A [B, J, 12]`` (row-major 3x4) and posed template
    vertices ``vp [B, V, 3]``: ``T[4r+3] + sum_k T[4r+k] vp[k]`` with
    ``T = W[v] @ A[b]``, never materialised in device memory.

    CPU tensors take the plain version; CUDA tensors (contiguous f32, at
    most 64 joints) launch the kernel, anything else raises."""
    _check(W, A, vp)
    if _build.on_cpu(W, A, vp):
        return skin_forward_plain(W, A, vp)
    for what, t, n in (("W", W, 2), ("A", A, 3), ("vp", vp, 3)):
        _build.require(f"skin_forward {what}", t, torch.float32, n)
    B, V, _ = vp.shape
    J = W.shape[1]
    if J > MAX_JOINTS:
        raise ValueError(f"skin_forward: {J} joints exceed {MAX_JOINTS}")
    out = torch.empty((B, V, 3), dtype=torch.float32, device=vp.device)
    _build.launch("skinning", "skin_fwd_f32", vp.device,
                  [W.data_ptr(), A.data_ptr(), vp.data_ptr(), out.data_ptr()],
                  [B, V, J])
    skin_forward.launches += 1
    return out


def skin_backward(W: torch.Tensor, A: torch.Tensor, vp: torch.Tensor,
                  g: torch.Tensor):
    """``(dA [B, J, 12], dvp [B, V, 3])``, the gradients of
    ``(skin_forward(W, A, vp) * g).sum()``; ``dA`` is summed per tile of
    :data:`TILE` vertices, then over tiles in order, without atomics.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (one tile pass and one sum over tiles), anything else raises."""
    _check(W, A, vp)
    if g.shape != vp.shape:
        raise ValueError(f"skin_backward: g {tuple(g.shape)} must match vp "
                         f"{tuple(vp.shape)}")
    if _build.on_cpu(W, A, vp, g):
        return skin_backward_plain(W, A, vp, g)
    for what, t, n in (("W", W, 2), ("A", A, 3), ("vp", vp, 3), ("g", g, 3)):
        _build.require(f"skin_backward {what}", t, torch.float32, n)
    B, V, _ = vp.shape
    J = W.shape[1]
    if J > MAX_JOINTS:
        raise ValueError(f"skin_backward: {J} joints exceed {MAX_JOINTS}")
    tiles = -(-V // TILE)
    dvp = torch.empty((B, V, 3), dtype=torch.float32, device=vp.device)
    dA = torch.empty((B, J, 12), dtype=torch.float32, device=vp.device)
    part = torch.empty((B, tiles, J, 12), dtype=torch.float32,
                       device=vp.device)
    _build.launch("skinning", "skin_bwd_f32", vp.device,
                  [W.data_ptr(), A.data_ptr(), vp.data_ptr(), g.data_ptr(),
                   dvp.data_ptr(), dA.data_ptr(), part.data_ptr()],
                  [B, V, J])
    skin_backward.launches += 1
    return dA, dvp


skin_forward.launches = 0
skin_backward.launches = 0


class FusedSkinning(torch.autograd.Function):
    """:func:`skin_forward` with :func:`skin_backward` as its gradient;
    ``W`` gets none."""

    @staticmethod
    def forward(ctx, W, A, vp):
        ctx.save_for_backward(W, A, vp)
        return skin_forward(W, A, vp)

    @staticmethod
    def backward(ctx, g):
        W, A, vp = ctx.saved_tensors
        dA, dvp = skin_backward(W, A, vp, g.contiguous())
        return None, dA, dvp


def fused_skinning(W: torch.Tensor, A: torch.Tensor,
                   vp: torch.Tensor) -> torch.Tensor:
    """Differentiable fused skinning (see :func:`skin_forward`)."""
    return FusedSkinning.apply(W, A.contiguous(), vp.contiguous())
