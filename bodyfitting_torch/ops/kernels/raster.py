"""Z-buffer rasterization: nearest perspective-correct depth, winning face,
and (fused) perspective-correct interpolation of per-corner attributes.

Port of ``bodyfitting_tpu.ops.pallas_kernels.rasterize_zbuf``
(pallas_kernels.py:508; kernel ``_raster_kernel`` :445) and
``rasterize_attrs_prepacked`` (:779; kernel ``_raster_attr_kernel`` :641,
glue ``_raster_attr_pack`` :717) as ``ops/csrc/raster.cu``.

Contract, for ``face_px [F, 3, 2]`` screen corners (pixels), ``face_z
[F, 3]`` camera depths and an ``image_size``² image (rows are y, pixel
centres at +0.5):

* a face is *front* when all three ``z > 1e-9``; ``iz_k = 1 / max(z_k,
  1e-9)``;
* it covers a pixel centre ``p`` when ``p`` lies in the face's closed
  bounding box, inside the triangle by its edge functions (either
  winding), and ``|area| > 1e-9``.  The edge functions e0, e1, e2 and the
  area are the TPU kernel's, in its operation order (:479-482);
* ``wiz_k = (e_k / area) iz_k``, ``inv_z = (wiz0 + wiz1) + wiz2``,
  ``depth = 1 / m`` with ``m = inv_z`` if ``inv_z > 1e-9`` else ``1e-9``;
* the winner is the front covering face of least depth, ties to the
  least caller face index; a depth of ``1e9`` (FAR) never wins.  Face
  indices come back in the caller's numbering, ``-1`` and depth FAR on
  the background;
* attributes are ``((wiz0 a0 + wiz1 a1) + wiz2 a2) depth`` of the winner,
  0 on the background.

The box test is part of the contract so that the kernel, which visits
only the pixels of each face's box, changes no result.  It differs from
a bare edge-function test only where rounding puts a pixel centre
outside a sliver's box on its edge lines.  A face
with a NaN corner covers nothing (its edge tests fail) and hides
nothing; a face with any ``z <= 1e-9`` never wins.

The plain versions below sweep the faces in the caller's order, one band
of 16 pixel rows and one chunk of faces at a time; the CUDA kernels
write the same operations in the same order (built with ``-fmad=false``),
so on the card depth and attributes are bitwise equal and face indices
exactly equal.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

EPS = 1e-9
FAR = 1e9
TILE = 16                 # pixel rows per band of the plain versions
PAIR_BUDGET = 1 << 22     # pixel-face pairs per plain-version chunk
SUB = 8                   # sub-box side of the kernel's work items (kSub)
SWEEP_BLOCKS = 4096       # most blocks of 256 threads in the sweep's grid


def face_terms(face_px: torch.Tensor, face_z: torch.Tensor) -> dict:
    """Per-face corners, inverse depths, front flag and bounding box."""
    ax, ay = face_px[:, 0, 0], face_px[:, 0, 1]
    bx, by = face_px[:, 1, 0], face_px[:, 1, 1]
    cx, cy = face_px[:, 2, 0], face_px[:, 2, 1]
    zc = torch.clamp(face_z, min=EPS)
    iz = torch.ones_like(zc) / zc
    front = (face_z > EPS).all(dim=1)
    return dict(
        ax=ax, ay=ay, bx=bx, by=by, cx=cx, cy=cy,
        iz0=iz[:, 0], iz1=iz[:, 1], iz2=iz[:, 2], front=front,
        x0=torch.minimum(torch.minimum(ax, bx), cx),
        x1=torch.maximum(torch.maximum(ax, bx), cx),
        y0=torch.minimum(torch.minimum(ay, by), cy),
        y1=torch.maximum(torch.maximum(ay, by), cy),
    )


def shade(px, py, f: dict):
    """``(ok, depth, (wiz0, wiz1, wiz2))`` of pixel centres ``(px, py)``
    against faces ``f`` (broadcasting): ``ok`` is the coverage test of the
    contract (box, edges, area, front); ``depth`` is meaningful where
    ``ok``."""
    ax, ay, bx, by, cx, cy = (f[k] for k in ("ax", "ay", "bx", "by", "cx",
                                             "cy"))
    e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
              | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    big = area.abs() > EPS
    inbox = (px >= f["x0"]) & (px <= f["x1"]) & (py >= f["y0"]) & (
        py <= f["y1"])
    ok = inbox & inside & big & f["front"]
    denom = torch.where(big, area, torch.ones_like(area))
    wiz0 = (e0 / denom) * f["iz0"]
    wiz1 = (e1 / denom) * f["iz1"]
    wiz2 = (e2 / denom) * f["iz2"]
    inv_z = (wiz0 + wiz1) + wiz2
    m = torch.where(inv_z > EPS, inv_z, torch.full_like(inv_z, EPS))
    depth = torch.ones_like(m) / m
    return ok, depth, (wiz0, wiz1, wiz2)


def _pixel_centres(H: int, W: int, dtype, device):
    xs = torch.arange(W, dtype=dtype, device=device) + 0.5
    ys = torch.arange(H, dtype=dtype, device=device) + 0.5
    return xs, ys


def rasterize_zbuf_plain(face_px: torch.Tensor, face_z: torch.Tensor,
                         image_size: int):
    """PyTorch version of :func:`rasterize_zbuf` (any dtype/device):
    ``(depth [H, W], face_idx [H, W] int32)``.  Bands of 16 pixel rows;
    in each, the faces whose box meets the band's rows, in caller order,
    ``PAIR_BUDGET`` pixel-face pairs at a time."""
    H = W = int(image_size)
    dev, dt = face_px.device, face_px.dtype
    depth = torch.full((H, W), FAR, dtype=dt, device=dev)
    fidx = torch.full((H, W), -1, dtype=torch.int64, device=dev)
    F = face_px.shape[0]
    if F == 0:
        return depth, fidx.to(torch.int32)
    f = face_terms(face_px, face_z)
    xs, ys = _pixel_centres(H, W, dt, dev)
    for r0 in range(0, H, TILE):
        r1 = min(r0 + TILE, H)
        yb0, yb1 = r0 + 0.5, r1 - 0.5
        sel = torch.nonzero(f["front"] & (f["y1"] >= yb0) & (f["y0"] <= yb1)
                            & (f["x1"] >= 0.5) & (f["x0"] <= W - 0.5))[:, 0]
        if sel.numel() == 0:
            continue
        py = ys[r0:r1, None].expand(r1 - r0, W).reshape(-1, 1)
        px = xs[None, :].expand(r1 - r0, W).reshape(-1, 1)
        best = depth[r0:r1].reshape(-1)
        bidx = fidx[r0:r1].reshape(-1)
        chunk = max(1, PAIR_BUDGET // px.shape[0])
        for s in range(0, sel.numel(), chunk):
            ids = sel[s:s + chunk]
            fc = {k: v[ids][None, :] for k, v in f.items()}
            ok, d, _ = shade(px, py, fc)
            d = torch.where(ok, d, torch.full_like(d, FAR))
            dmin, arg = d.min(dim=1)          # first index among equals
            better = dmin < best
            best = torch.where(better, dmin, best)
            bidx = torch.where(better, ids[arg], bidx)
        depth[r0:r1] = best.reshape(r1 - r0, W)
        fidx[r0:r1] = bidx.reshape(r1 - r0, W)
    return depth, fidx.to(torch.int32)


def winner_attrs(face_px, face_z, face_attrs, fidx, image_size):
    """``[H, W, A]`` attributes of each pixel's winning face ``fidx``
    (caller numbering, ``-1`` background -> 0), and its depth: the winner's
    arithmetic of :func:`shade`, evaluated again on the winner alone."""
    H = W = int(image_size)
    A = face_attrs.shape[-1]
    dev, dt = face_px.device, face_px.dtype
    flat = fidx.reshape(-1).long()
    won = torch.nonzero(flat >= 0)[:, 0]
    out = torch.zeros((H * W, A), dtype=dt, device=dev)
    if won.numel() == 0:
        return out.reshape(H, W, A)
    w = flat[won]
    f = {k: v[w] for k, v in face_terms(face_px, face_z).items()}
    xs, ys = _pixel_centres(H, W, dt, dev)
    _, depth, (wiz0, wiz1, wiz2) = shade(xs[won % W], ys[won // W], f)
    a = face_attrs[w].to(dt)                       # [N, 3, A]
    vals = ((wiz0[:, None] * a[:, 0] + wiz1[:, None] * a[:, 1])
            + wiz2[:, None] * a[:, 2]) * depth[:, None]
    out[won] = vals
    return out.reshape(H, W, A)


def rasterize_attrs_plain(face_px: torch.Tensor, face_z: torch.Tensor,
                          face_attrs: torch.Tensor, image_size: int):
    """PyTorch version of :func:`rasterize_attrs` (any dtype/device):
    :func:`rasterize_zbuf_plain`, then the winner's attributes."""
    depth, fidx = rasterize_zbuf_plain(face_px, face_z, image_size)
    attrs = winner_attrs(face_px, face_z, face_attrs, fidx, image_size)
    return attrs, fidx, depth


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _check(name, face_px, face_z, image_size, face_attrs=None):
    f32 = torch.float32
    _build.require(f"{name} face_px", face_px, f32, 3)
    _build.require(f"{name} face_z", face_z, f32, 2)
    F = face_px.shape[0]
    if face_px.shape[1:] != (3, 2) or face_z.shape != (F, 3):
        raise ValueError(f"{name} shapes {tuple(face_px.shape)}, "
                         f"{tuple(face_z.shape)}: expected [F, 3, 2], [F, 3]")
    if face_attrs is not None:
        _build.require(f"{name} face_attrs", face_attrs, f32, 3)
        if face_attrs.shape[:2] != (F, 3) or face_attrs.shape[2] < 1:
            raise ValueError(f"{name} face_attrs {tuple(face_attrs.shape)}: "
                             f"expected [F={F}, 3, A >= 1]")
    if int(image_size) < 1 or int(image_size) ** 2 >= 2 ** 31:
        raise ValueError(f"{name}: image_size {image_size} out of range")


def work_items(face_px: torch.Tensor, face_z: torch.Tensor, H: int, W: int):
    """What the kernel's sweep reads: each face's pixel box ``(first
    column, first row, columns, rows)`` int32, a superset of the pixel
    centres in its bounding box clamped to the image (no columns for a
    face that cannot win: not front, or a corner not finite), and the
    inclusive prefix sum of its ``SUB``x``SUB`` sub-boxes, int64."""
    live = (face_z > EPS).all(dim=1) & torch.isfinite(face_px).all(dim=2).all(
        dim=1)
    lo = torch.nan_to_num(face_px.amin(dim=1))
    hi = torch.nan_to_num(face_px.amax(dim=1))
    first, n = [], []
    for k, size in enumerate((W, H)):         # scalars: no host-device copy
        f = torch.floor(torch.clamp(lo[:, k], -1.0, size + 1.0) - 0.5)
        last = torch.ceil(torch.clamp(hi[:, k], -1.0, size + 1.0) - 0.5)
        f = torch.clamp(f, min=0)
        first.append(f)
        n.append(torch.clamp(torch.clamp(last, max=size - 1) - f + 1, min=0)
                 * live)
    first, n = torch.stack(first, 1), torch.stack(n, 1)
    first, n = first.to(torch.int32), n.to(torch.int32)
    box = torch.cat([first, n], dim=1).contiguous()          # [F, 4]
    subs = (-(-n.long() // SUB)).prod(dim=1)
    return box, torch.cumsum(subs, 0)


def _launch(symbol, face_px, face_z, image_size, face_attrs=None):
    H = W = int(image_size)
    dev = face_px.device
    F = face_px.shape[0]
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    fidx = torch.empty((H, W), dtype=torch.int32, device=dev)
    A = 0 if face_attrs is None else face_attrs.shape[2]
    attrs = torch.empty((H, W, max(A, 1)), dtype=torch.float32, device=dev)
    keys = torch.full((H, W), -1, dtype=torch.int64, device=dev)  # all ones
    if F:
        box, offsets = work_items(face_px, face_z, H, W)
    else:
        box = torch.zeros(4, dtype=torch.int32, device=dev)
        offsets = torch.zeros(1, dtype=torch.int64, device=dev)
    blocks = max(1, min(SWEEP_BLOCKS, -(-F // 256)))
    ins = [face_px.data_ptr(), face_z.data_ptr(), box.data_ptr(),
           offsets.data_ptr()]
    outs = [keys.data_ptr(), depth.data_ptr(), fidx.data_ptr()]
    if A:
        _build.launch("raster", symbol, dev,
                      ins + [face_attrs.data_ptr()] + outs
                      + [attrs.data_ptr()], [H, W, F, A, blocks])
    else:
        _build.launch("raster", symbol, dev, ins + outs, [H, W, F, blocks])
    return depth, fidx, attrs[..., :A]


def rasterize_zbuf(face_px: torch.Tensor, face_z: torch.Tensor,
                   image_size: int):
    """Z-buffer pass: ``(depth [H, W], face_idx [H, W] int32)`` under the
    module's contract, ``H = W = image_size``.  Not differentiable.

    CPU tensors take the plain version; CUDA tensors (contiguous f32)
    launch the kernel, anything else raises.  On the card each thread
    takes an 8x8 pixel sub-box of one face's box and merges its hits into
    the pixels' (depth, index) keys with a 64-bit atomic minimum.
    """
    if _build.on_cpu(face_px, face_z):
        return rasterize_zbuf_plain(face_px, face_z, image_size)
    _check("rasterize_zbuf", face_px, face_z, image_size)
    depth, fidx, _ = _launch("rasterize_zbuf_f32", face_px, face_z,
                             image_size)
    rasterize_zbuf.launches += 1
    return depth, fidx


def rasterize_attrs(face_px: torch.Tensor, face_z: torch.Tensor,
                    face_attrs: torch.Tensor, image_size: int):
    """Z-buffer fused with perspective-correct interpolation of per-corner
    attributes ``face_attrs [F, 3, A]``: ``(attrs [H, W, A], face_idx
    [H, W] int32, depth [H, W])``, attrs 0 and face_idx -1 on the
    background.  Not differentiable.

    CPU tensors take the plain version; CUDA tensors (contiguous f32)
    launch the kernel, anything else raises.  The kernel interpolates the
    winner's attributes once, after its sweep, with the arithmetic that
    gave the winner its depth.
    """
    if _build.on_cpu(face_px, face_z, face_attrs):
        return rasterize_attrs_plain(face_px, face_z, face_attrs, image_size)
    _check("rasterize_attrs", face_px, face_z, image_size, face_attrs)
    depth, fidx, attrs = _launch("rasterize_attrs_f32", face_px, face_z,
                                 image_size, face_attrs)
    rasterize_attrs.launches += 1
    return attrs, fidx, depth


rasterize_zbuf.launches = 0
rasterize_attrs.launches = 0
