"""Zero-padded bilinear sample + coverage + position derivatives.

Port of ``bodyfitting_tpu.ops.pallas_kernels.bilinear_cov_grads``
(kernel ``_bilinear_cov_kernel``, pallas_kernels.py:1242).  The CUDA
kernel is ``ops/csrc/bilinear.cu``; ``bilinear_cov_grads_plain`` computes
the same contract in PyTorch and serves CPU tensors.  The frame x view
axis is an explicit leading batch axis ``BV``.  The JAX ``row_window`` and
``band_rows`` tiling knobs have no counterpart: one kernel computes the
function for every point layout.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build


def bilinear_cov_grads_plain(img: torch.Tensor, xy: torch.Tensor,
                             with_grads: bool = True,
                             with_cov: bool = True) -> torch.Tensor:
    """PyTorch version of :func:`bilinear_cov_grads` (any dtype/device);
    the same arithmetic in the same order as the CUDA kernel."""
    BV, H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    near = (x > -1.0) & (x < W) & (y > -1.0) & (y < H)
    x = torch.where(near, x, 0.0)
    y = torch.where(near, y, 0.0)
    fx, fy = torch.floor(x), torch.floor(y)
    x0, y0 = fx.long(), fy.long()
    wx, wy = x - fx, y - fy
    ux, uy = 1.0 - wx, 1.0 - wy
    flat = img.reshape(BV, H * W)

    def inb(r, c):
        return (r >= 0) & (r < H) & (c >= 0) & (c < W)

    def tap(r, c):
        lin = r.clamp(0, H - 1) * W + c.clamp(0, W - 1)
        return torch.where(inb(r, c), flat.gather(1, lin), 0.0)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    zero = torch.zeros_like(x)
    s = uy * (ux * v00 + wx * v01) + wy * (ux * v10 + wx * v11)
    gx = (wx > 0.0).to(x.dtype)
    gy = (wy > 0.0).to(x.dtype)
    sx = sy = c = cx = cy = zero
    if with_grads:
        sx = gx * (uy * (v01 - v00) + wy * (v11 - v10))
        sy = gy * (ux * (v10 - v00) + wx * (v11 - v01))
    if with_cov:
        r0 = ((y0 >= 0) & (y0 < H)).to(x.dtype)
        r1 = ((y0 + 1 >= 0) & (y0 + 1 < H)).to(x.dtype)
        c0 = ((x0 >= 0) & (x0 < W)).to(x.dtype)
        c1 = ((x0 + 1 >= 0) & (x0 + 1 < W)).to(x.dtype)
        rsum = uy * r0 + wy * r1
        csum = ux * c0 + wx * c1
        c = rsum * csum
        if with_grads:
            cx = rsum * (gx * (c1 - c0))
            cy = (gy * (r1 - r0)) * csum
    rows = [torch.where(near, v, 0.0) for v in (s, c, sx, sy, cx, cy)]
    return torch.stack(rows, dim=1)


def bilinear_cov_grads(img: torch.Tensor, xy: torch.Tensor,
                       with_grads: bool = True,
                       with_cov: bool = True) -> torch.Tensor:
    """Fused zero-padded bilinear sample, coverage and derivatives.

    img ``[BV, H, W]``; xy ``[BV, N, 2]`` positions in pixel-grid units
    (already scaled by ``(size-1)/imsize``).  Returns ``[BV, 6, N]``:
    sample, coverage (the sample of an all-ones image), ds/dx, ds/dy,
    dc/dx, dc/dy.  Rows 1, 4, 5 are zero without ``with_cov``; rows 2-5
    without ``with_grads``.  A coordinate that is an exact integer has
    derivative 0 (the TPU kernel's ``sign()`` rule).

    CPU tensors take the plain version; CUDA tensors (contiguous f32)
    launch the kernel, anything else raises.
    """
    if _build.on_cpu(img, xy):
        return bilinear_cov_grads_plain(img, xy, with_grads, with_cov)
    _build.require("bilinear_cov_grads img", img, torch.float32, 3)
    _build.require("bilinear_cov_grads xy", xy, torch.float32, 3)
    BV, H, W = img.shape
    if xy.shape[0] != BV or xy.shape[2] != 2:
        raise ValueError(f"xy {tuple(xy.shape)} does not match img "
                         f"{tuple(img.shape)}")
    N = xy.shape[1]
    out = torch.empty((BV, 6, N), dtype=torch.float32, device=img.device)
    _build.launch(
        "bilinear", "bilinear_cov_grads_f32", img.device,
        [img.data_ptr(), xy.data_ptr(), out.data_ptr()],
        [BV, H, W, N, bool(with_grads), bool(with_cov)],
    )
    bilinear_cov_grads.launches += 1
    return out


bilinear_cov_grads.launches = 0
