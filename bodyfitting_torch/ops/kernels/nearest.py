"""Nearest point-on-mesh: minimum point-triangle d² and the winning face.

Port of ``bodyfitting_tpu.ops.pallas_kernels.nearest_d2_idx``
(pallas_kernels.py:231; kernels ``_nearest_kernel`` :49 and
``_nearest_tie_kernel`` :161) as ``ops/csrc/nearest.cu``.  Both always
apply the tie rule of ``ops.nearest.tie_threshold``: the result is the
lowest face index whose distance is within the rounding band of the
minimum, so it does not depend on the order in which faces are visited:
the kernel visits them in Morton order and skips blocks of them by their
bounding boxes, the plain version sweeps them in index order.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

BIG_IDX = 2 ** 30          # "no face in the band yet", as the TPU kernel
FACE_BLOCK = 512
CULL_BLOCK = 32            # faces per bounding box (kBlockFaces in the .cu)
WARP_QUERIES = 8           # queries per warp (kWarpQueries in the .cu)


def diag2_of(verts: torch.Tensor) -> torch.Tensor:
    """Squared diagonal of the bounding box of ``verts [V, 3]``, summed
    x, y, z in that order."""
    ext = verts.max(dim=0).values - verts.min(dim=0).values
    return ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2]


def tie_threshold(best_d2: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """``best + 32 eps (best + diag²)``: the distance² band that counts as
    tied with the minimum (``ops.nearest.tie_threshold`` of the JAX
    package).  The relative term absorbs rounding between two evaluations
    of one tie; the absolute term catches minima of exactly zero (queries
    on the surface).  ``eps`` is that of the working dtype."""
    eps = torch.finfo(best_d2.dtype).eps
    return best_d2 + 32.0 * eps * (best_d2 + diag2_of(verts))


def closest_point_on_triangles(p, a, b, c):
    """Closest point to ``p`` on each triangle ``(a, b, c)``; all inputs
    broadcast, ``[..., 3]`` -> ``[..., 3]``.  Branchless Voronoi-region
    classification, one elementwise op at a time in the order of the TPU
    kernel's ``_block_dist2``.  No ``sum(-1)`` over xyz: every dot is
    ``(x + y) + z`` written out, so the CUDA kernel can repeat it bit for
    bit."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az

    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe_div(num, den):
        return num / torch.where(den.abs() > 1e-30, den, 1e-30)

    t_ab = torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v = vb * denom
    w = vc * denom

    ox = ax + abx * v + acx * w
    oy = ay + aby * v + acy * w
    oz = az + abz * v + acz * w

    def sel(cond, tx, ty, tz):
        return (torch.where(cond, tx, ox), torch.where(cond, ty, oy),
                torch.where(cond, tz, oz))

    # regions, highest priority last (the last select wins)
    ox, oy, oz = sel((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
                     bx + t_bc * (cx - bx), by + t_bc * (cy - by),
                     bz + t_bc * (cz - bz))
    ox, oy, oz = sel((vb <= 0) & (d2 >= 0) & (d6 <= 0),
                     ax + t_ac * acx, ay + t_ac * acy, az + t_ac * acz)
    ox, oy, oz = sel((vc <= 0) & (d1 >= 0) & (d3 <= 0),
                     ax + t_ab * abx, ay + t_ab * aby, az + t_ab * abz)
    ox, oy, oz = sel((d6 >= 0) & (d5 <= d6), cx, cy, cz)
    ox, oy, oz = sel((d3 >= 0) & (d4 <= d3), bx, by, bz)
    ox, oy, oz = sel((d1 <= 0) & (d2 <= 0), ax, ay, az)
    return torch.stack([ox, oy, oz], dim=-1)


def tri_dist2(p, tri):
    """Point-triangle squared distances ``|p - closest|²``: ``p [Q, 1, 3]``
    (or any shape broadcasting against ``tri [..., 3, 3]``'s leading axes)
    -> the broadcast shape, summed x, y, z in that order."""
    d = p - closest_point_on_triangles(p, tri[..., 0, :], tri[..., 1, :],
                                       tri[..., 2, :])
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def nearest_d2_idx_plain(points: torch.Tensor, tri: torch.Tensor,
                         tie_verts=None, face_block: int = FACE_BLOCK):
    """PyTorch version of :func:`nearest_d2_idx` (any dtype/device): a
    blocked sweep over ``face_block`` faces at a time (peak memory
    ``[Q, face_block]``), run twice: once for the minimum, once for the
    lowest index inside the tie band.  NaN distances never win."""
    Q, F = points.shape[0], tri.shape[0]
    dev = points.device
    verts = tri.reshape(-1, 3) if tie_verts is None else tie_verts
    p = points[:, None, :]
    best = torch.full((Q,), float("inf"), dtype=points.dtype, device=dev)
    for s in range(0, F, face_block):
        d2 = tri_dist2(p, tri[None, s:s + face_block])
        d2 = torch.where(torch.isnan(d2), float("inf"), d2)
        best = torch.minimum(best, d2.amin(dim=1))
    thr = tie_threshold(best, verts)[:, None]
    low = torch.full((Q,), BIG_IDX, dtype=torch.int64, device=dev)
    for s in range(0, F, face_block):
        d2 = tri_dist2(p, tri[None, s:s + face_block])
        fidx = torch.arange(s, s + d2.shape[1], device=dev)[None, :]
        cand = torch.where(d2 <= thr, fidx, BIG_IDX)
        low = torch.minimum(low, cand.amin(dim=1))
    low = torch.where(low == BIG_IDX, 0, low)
    return best, low.to(torch.int32)


def _morton(x: torch.Tensor, lo: torch.Tensor, ext: torch.Tensor):
    """30-bit Morton codes of ``x [N, 3]`` quantised to 1024 steps per axis
    of the box ``lo + [0, ext]`` (non-finite coordinates code as the
    box's corner)."""
    g = torch.nan_to_num((x - lo) / ext * 1023.0, nan=0.0, posinf=1023.0,
                         neginf=0.0)
    g = torch.clamp(g, 0.0, 1023.0).to(torch.int64)
    code = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for k in range(3):
        v = g[:, k]
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        code |= v << k
    return code


def _cull_inputs(points: torch.Tensor, tri: torch.Tensor):
    """What the kernel's cull reads: the queries' and faces' Morton orders,
    the sorted faces, each block of ``CULL_BLOCK`` sorted faces' bounding
    box, each warp's first face block, and the scale of the coordinates
    (``scale2 = 3 max|x|²`` over the non-NaN ones) that sizes the cull's
    rounding slack."""
    F = tri.shape[0]
    cent = tri.sum(dim=1) / 3.0
    both = torch.nan_to_num(torch.cat([points, cent]), nan=0.0, posinf=0.0,
                            neginf=0.0)
    lo = both.amin(dim=0)
    ext = torch.clamp(both.amax(dim=0) - lo, min=1e-30)
    qcode, qperm = torch.sort(_morton(points, lo, ext))
    fcode, fperm = torch.sort(_morton(cent, lo, ext))
    tri_s = tri[fperm].contiguous()
    nb = -(-F // CULL_BLOCK)
    # the ragged last block's box: its own faces, the last one repeated
    pad = tri_s[-1:].expand(nb * CULL_BLOCK - F, 3, 3)
    blocks = torch.cat([tri_s, pad]).reshape(nb, CULL_BLOCK * 3, 3)
    box = torch.cat([blocks.amin(dim=1), blocks.amax(dim=1)], dim=1)
    first = torch.searchsorted(fcode, qcode[::WARP_QUERIES].contiguous())
    seed = torch.clamp(first // CULL_BLOCK, max=nb - 1)
    # NaN coordinates are left out: no box test that reads one skips
    big = torch.maximum(*(torch.where(torch.isnan(x), 0.0, x).abs().amax()
                          for x in (points, tri)))
    return (qperm.to(torch.int32), tri_s, fperm.to(torch.int32),
            box.contiguous(), seed.to(torch.int32), 3.0 * big * big, nb)


def nearest_d2_idx(points: torch.Tensor, tri: torch.Tensor, tie_verts=None):
    """Minimum point-triangle squared distance and winning face.

    ``points [Q, 3]``, ``tri [F, 3, 3]``; ``tie_verts [V, 3]`` gives the
    bounding box of the tie band's absolute term (default: the triangles'
    corners).  Returns ``(d2 [Q], idx [Q] int32)``: ``d2`` the exact
    minimum, ``idx`` the lowest face index within
    :func:`tie_threshold` of it (0 when no face gives a number).  Not
    differentiable.

    CPU tensors take the plain version; CUDA tensors (contiguous f32)
    launch the kernel, anything else raises.  On the card the queries and
    faces are sorted by Morton code and the kernel skips face blocks whose
    bounding box lies beyond reach (``ops/csrc/nearest.cu``); the result
    is that of the plain sweep.
    """
    verts = tri.reshape(-1, 3) if tie_verts is None else tie_verts
    if _build.on_cpu(points, tri, verts):
        return nearest_d2_idx_plain(points, tri, tie_verts)
    f32 = torch.float32
    _build.require("nearest_d2_idx points", points, f32, 2)
    _build.require("nearest_d2_idx tri", tri, f32, 3)
    Q, F = points.shape[0], tri.shape[0]
    if points.shape[1] != 3 or tri.shape[1:] != (3, 3):
        raise ValueError(f"nearest_d2_idx shapes {tuple(points.shape)}, "
                         f"{tuple(tri.shape)}: expected [Q, 3], [F, 3, 3]")
    if verts.dtype != f32 or verts.dim() != 2 or verts.shape[1] != 3:
        raise ValueError(f"nearest_d2_idx tie_verts: expected f32 [V, 3], "
                         f"got {verts.dtype} {tuple(verts.shape)}")
    dev = points.device
    d2 = torch.empty((Q,), dtype=f32, device=dev)
    idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q and F:
        qperm, tri_s, fperm, box, seed, scale2, nb = _cull_inputs(points, tri)
    else:
        qperm = tri_s = fperm = box = seed = scale2 = torch.zeros(
            1, dtype=f32, device=dev)
        nb = 0
    consts = torch.stack([diag2_of(verts), scale2.reshape(())]).contiguous()
    _build.launch(
        "nearest", "nearest_d2_idx_f32", dev,
        [points.data_ptr(), qperm.data_ptr(), tri_s.data_ptr(),
         fperm.data_ptr(), box.data_ptr(), seed.data_ptr(),
         consts.data_ptr(), d2.data_ptr(), idx.data_ptr()],
        [Q, F, nb],
    )
    nearest_d2_idx.launches += 1
    return d2, idx


nearest_d2_idx.launches = 0
