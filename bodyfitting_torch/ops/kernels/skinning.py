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

# What csrc/skinning.cu's `geometry` chooses, restated for the CPU tests
# and the logs (the card's tests hold the two equal, see kernel_geometry):
# the forward's (TV, FB, VR); the backward's latency and throughput
# (FB, VR, CW), and the frames and (vertex, frame) pairs from which it
# takes the throughput one (kWideFrames, kWidePairs there).
_FWD = (64, 4, 2)
_BWD = ((1, 1, 4), (4, 4, 12))
WIDE_FRAMES = 32
WIDE_PAIRS = 50_000

GEOMETRY_KEYS = ("TV", "FB", "VR", "CW", "threads", "blocks", "smem_bytes")


def launch_geometry(B: int, V: int, J: int, backward: bool,
                    wide: int = -1) -> dict:
    """The kernels' launch geometry for ``B`` frames of ``V`` vertices and
    ``J`` joints, as ``csrc/skinning.cu`` chooses it: a block takes ``TV``
    vertices (the backward: one :data:`TILE`) x ``FB`` frames, a thread
    ``VR`` vertices of one frame; in the backward, each of ``FB * 12 /
    CW`` more warps sums ``CW`` columns of one frame's ``dA`` partial.
    ``wide`` picks the backward's geometry: -1 by size (from
    :data:`WIDE_FRAMES` frames and :data:`WIDE_PAIRS` pairs on, the
    throughput one), 0 the latency one, 1 the throughput one.  With ``threads``, ``blocks`` and ``smem_bytes``
    (dynamic shared memory a block) as the launch asks for them."""
    if not backward:
        (TV, FB, VR), CW = _FWD, 0
    else:
        if wide < 0:
            wide = int(B >= WIDE_FRAMES and B * V >= WIDE_PAIRS)
        TV, (FB, VR, CW) = TILE, _BWD[wide]
    FB = max(1, min(FB, B))
    tiles = -(-V // TV)
    if backward:
        tiles = max(1, tiles)
    threads = TV // VR * FB + (32 * FB * 12 // CW if backward else 0)
    smem = 4 * (TV * J + FB * J * 12 + (FB * TV * 12 if backward else 0))
    return dict(TV=TV, FB=FB, VR=VR, CW=CW, threads=threads,
                blocks=tiles * -(-B // FB), smem_bytes=smem)


def kernel_geometry(B: int, V: int, J: int, backward: bool,
                    wide: int = -1) -> dict:
    """The launch geometry that the built kernels report (``skin_geometry``;
    builds them if needed), keyed as :func:`launch_geometry`."""
    return _build.geometry("skinning", "skin_geometry",
                           [B, V, J, int(backward), wide], GEOMETRY_KEYS)


_COUNTERS: dict = {}


def _counters(device, stream, n: int) -> torch.Tensor:
    """The backward's per-group election counters for launches on
    ``stream``: zero, and left zero by every launch, so one buffer serves
    every call on that stream (calls on one stream never overlap)."""
    key = (device, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = cnt
    return cnt


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


def _aligned(what: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel's bulk copies need 16-byte "
                             f"aligned W and A (data_ptr {t.data_ptr():#x})")


def skin_forward(W: torch.Tensor, A: torch.Tensor,
                 vp: torch.Tensor) -> torch.Tensor:
    """``verts [B, V, 3]`` from skinning weights ``W [V, J]``, blended
    transforms ``A [B, J, 12]`` (row-major 3x4) and posed template
    vertices ``vp [B, V, 3]``: ``T[4r+3] + sum_k T[4r+k] vp[k]`` with
    ``T = W[v] @ A[b]``, never materialised in device memory.

    CPU tensors take the plain version; CUDA tensors (contiguous f32, at
    most 64 joints, ``W`` and ``A`` 16-byte aligned) launch the kernel,
    anything else raises."""
    _check(W, A, vp)
    if _build.on_cpu(W, A, vp):
        return skin_forward_plain(W, A, vp)
    for what, t, n in (("W", W, 2), ("A", A, 3), ("vp", vp, 3)):
        _build.require(f"skin_forward {what}", t, torch.float32, n)
    B, V, _ = vp.shape
    J = W.shape[1]
    if J > MAX_JOINTS:
        raise ValueError(f"skin_forward: {J} joints exceed {MAX_JOINTS}")
    _aligned("skin_forward", W, A)
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
    :data:`TILE` vertices, then over tiles in order, without float
    atomics.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch: tile partials, then the last tile block of each frame
    group sums them), anything else raises."""
    _check(W, A, vp)
    if g.shape != vp.shape:
        raise ValueError(f"skin_backward: g {tuple(g.shape)} must match vp "
                         f"{tuple(vp.shape)}")
    if _build.on_cpu(W, A, vp, g):
        return skin_backward_plain(W, A, vp, g)
    return _launch_backward(W, A, vp, g, -1)


def _launch_backward(W, A, vp, g, wide: int):
    """:func:`skin_backward`'s launch on CUDA tensors, in the geometry
    ``wide`` names (see :func:`launch_geometry`; the wrapper asks for -1,
    ``bench_skin_kernels.py --geometries`` times 0 and 1 apart)."""
    for what, t, n in (("W", W, 2), ("A", A, 3), ("vp", vp, 3), ("g", g, 3)):
        _build.require(f"skin_backward {what}", t, torch.float32, n)
    B, V, _ = vp.shape
    J = W.shape[1]
    if J > MAX_JOINTS:
        raise ValueError(f"skin_backward: {J} joints exceed {MAX_JOINTS}")
    _aligned("skin_backward", W, A)
    tiles = max(1, -(-V // TILE))
    dev = vp.device
    dvp = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
    dA = torch.empty((B, J, 12), dtype=torch.float32, device=dev)
    part = torch.empty((B, tiles, J, 12), dtype=torch.float32, device=dev)
    cnt = _counters(dev, torch.cuda.current_stream(dev).cuda_stream, B)
    _build.launch("skinning", "skin_bwd_f32", dev,
                  [W.data_ptr(), A.data_ptr(), vp.data_ptr(), g.data_ptr(),
                   dvp.data_ptr(), dA.data_ptr(), part.data_ptr(),
                   cnt.data_ptr()],
                  [B, V, J, wide])
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
