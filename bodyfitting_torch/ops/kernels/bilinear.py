"""Zero-padded bilinear sample + coverage + position derivatives.

Port of ``bodyfitting_tpu.ops.pallas_kernels.bilinear_cov_grads``
(kernel ``_bilinear_cov_kernel``, pallas_kernels.py:1242).  The CUDA
kernel is ``ops/csrc/bilinear.cu``; ``bilinear_cov_grads_plain`` computes
the same contract in PyTorch and serves CPU tensors.  The frame x view
axis is an explicit leading batch axis ``BV``.  The JAX ``row_window`` and
``band_rows`` tiling knobs have no counterpart: one kernel computes the
function for every point layout.

The image is float32 or a bit mask: int32 words from :func:`pack_bits`,
32 pixels a word (the main path's 0/1 mask crops, see
``losses/silhouette.py:mask_crops_bits``).  A mask bit converts to float
exactly, so a 0/1 image gives the same sample and derivatives in both
types.  A bit mask pads each row to a multiple of 32 pixels, so it is
sampled without coverage, which would count the padding.
"""

from __future__ import annotations

import torch

from bodyfitting_torch.ops.kernels import _build

# The kernel's C symbol for each image type.
_SYMBOLS = {torch.float32: "bilinear_cov_grads_f32",
            torch.int32: "bilinear_cov_grads_b1"}

# Threads a block, a point a thread, as csrc/bilinear.cu chooses it;
# restated for the CPU tests (the card's tests hold the two equal, see
# kernel_geometry).
THREADS = 256

GEOMETRY_KEYS = ("blocks", "threads")


def launch_geometry(BV: int, N: int) -> dict:
    """The kernel's launch geometry for ``BV x N`` points, as
    ``csrc/bilinear.cu`` chooses it: one flat grid, a point a thread."""
    return dict(blocks=-(-BV * N // THREADS), threads=THREADS)


def kernel_geometry(BV: int, N: int) -> dict:
    """The launch geometry that the built kernel reports
    (``bilinear_cov_grads_geometry``; builds it if needed), keyed as
    :func:`launch_geometry`."""
    return _build.geometry("bilinear", "bilinear_cov_grads_geometry",
                           [BV, N], GEOMETRY_KEYS)


def _check_bits(img: torch.Tensor, with_cov: bool) -> None:
    if img.dtype == torch.int32 and with_cov:
        raise ValueError("bilinear_cov_grads: a bit mask is sampled without "
                         "coverage (with_cov=False); its rows are padded to "
                         "a multiple of 32 pixels")


def pack_bits(img: torch.Tensor) -> torch.Tensor:
    """A 0/1 image ``[..., H, W]`` (any dtype) as a bit mask ``[..., H,
    ceil(W / 32)]`` of int32 words: pixel ``c`` of a row is bit ``c % 32``
    of word ``c // 32`` (a nonzero value packs as 1); the columns from
    ``W`` up to the next multiple of 32 are zero pixels."""
    *lead, W = img.shape
    Wq = -(-W // 32)
    bits = torch.zeros((*lead, Wq * 32), dtype=torch.int32,
                       device=img.device)
    bits[..., :W] = img != 0
    # bit j of a two's-complement int32 word weighs 2^j, bit 31 -2^31
    weights = torch.tensor([1 << j for j in range(31)] + [-(1 << 31)],
                           dtype=torch.int32, device=img.device)
    return (bits.reshape(*lead, Wq, 32) * weights).sum(-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """The uint8 image ``[..., H, 32 Wq]`` of a bit mask ``[..., H, Wq]``
    (:func:`pack_bits`)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(*words.shape[:-1], -1)


def bilinear_cov_grads_plain(img: torch.Tensor, xy: torch.Tensor,
                             with_grads: bool = True,
                             with_cov: bool = True) -> torch.Tensor:
    """PyTorch version of :func:`bilinear_cov_grads` (any dtype/device);
    the same arithmetic in the same order as the CUDA kernel.  Taps are
    converted to ``xy``'s dtype as they are read, as the kernel converts
    mask bits to float."""
    _check_bits(img, with_cov)
    if img.dtype == torch.int32:
        img = unpack_bits(img)
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
        return torch.where(inb(r, c), flat.gather(1, lin).to(x.dtype), 0.0)

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

    ``img`` may be a bit mask (int32 words of :func:`pack_bits`), sampled
    as the image of width ``32 * img.shape[2]``, and then only with
    ``with_cov=False`` (ValueError otherwise).

    CPU tensors take the plain version; CUDA tensors (a contiguous f32 or
    int32 image; contiguous f32 xy starting on an 8-byte boundary) launch
    the kernel, anything else raises.
    """
    _check_bits(img, with_cov)
    if _build.on_cpu(img, xy):
        return bilinear_cov_grads_plain(img, xy, with_grads, with_cov)
    symbol = _SYMBOLS.get(img.dtype)
    if symbol is None:
        raise ValueError(f"bilinear_cov_grads img: expected float32 or int32 "
                         f"(a bit mask), got {img.dtype}")
    _build.require("bilinear_cov_grads img", img, img.dtype, 3)
    _build.require("bilinear_cov_grads xy", xy, torch.float32, 3)
    if xy.data_ptr() % 8:
        raise ValueError("bilinear_cov_grads xy: the kernel reads a point "
                         "as one 8-byte vector; its data must start on an "
                         "8-byte boundary")
    BV, H, W = img.shape
    if xy.shape[0] != BV or xy.shape[2] != 2:
        raise ValueError(f"xy {tuple(xy.shape)} does not match img "
                         f"{tuple(img.shape)}")
    N = xy.shape[1]
    if img.dtype == torch.int32:
        W *= 32
    out = torch.empty((BV, 6, N), dtype=torch.float32, device=img.device)
    _build.launch(
        "bilinear", symbol, img.device,
        [img.data_ptr(), xy.data_ptr(), out.data_ptr()],
        [BV, H, W, N, bool(with_grads), bool(with_cov)],
    )
    bilinear_cov_grads.launches += 1
    return out


bilinear_cov_grads.launches = 0
