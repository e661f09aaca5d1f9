"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.
Tolerances as in ``chip_smoke.py``: the sampler, the match, the
nearest-point query, the rasterizers and the skinning round like their
plain versions (built with ``-fmad=false``), so they agree exactly;
the scatter and its plain version both sum in ascending ``p``, so they
agree bitwise too, and two launches are bitwise equal.
"""

import numpy as np
import pytest
import torch

from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops.kernels import skinning
from chip_smoke import (
    BILINEAR_MODES, bilinear_edge_cases, bilinear_images, match_edge_cases,
    scatter_edge_cases,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(a, device=dev)


@pytest.mark.parametrize("with_grads,with_cov",
                         [(True, False), (False, False), (True, True)])
def test_bilinear_kernel_matches_plain(dev, with_grads, with_cov):
    rng = np.random.default_rng(0)
    H, W, N = 40, 300, 1001
    img = (rng.random((3, H, W)) > 0.5).astype(np.float32)
    xy = rng.uniform(-3, [W + 2, H + 2], size=(3, N, 2)).astype(np.float32)
    xy[:, :20] = np.round(xy[:, :20])
    xy[:, 20] = [1e9, 5.0]
    xy[:, 21] = [np.nan, 3.0]
    img, xy = _t(img, dev), _t(xy, dev)
    before = K.bilinear_cov_grads.launches
    got = K.bilinear_cov_grads(img, xy, with_grads, with_cov)
    ref = K.bilinear_cov_grads_plain(img, xy, with_grads, with_cov)
    torch.cuda.synchronize()
    assert K.bilinear_cov_grads.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("with_grads,with_cov",
                         [(True, False), (False, False), (True, True)])
def test_bilinear_bit_mask_kernel_matches_plain(dev, with_grads, with_cov):
    """The bit-mask kernel (what the fits sample) bitwise its plain
    version and the f32 kernel on one 0/1 image; with coverage it is
    refused before any launch."""
    rng = np.random.default_rng(3)
    H, W, N = 368, 384, 2619
    img = (rng.random((4, H, W)) > 0.5).astype(np.float32)
    xy = rng.uniform(-3, [W + 2, H + 2], size=(4, N, 2)).astype(np.float32)
    xy[:, :20] = np.round(xy[:, :20])
    xy[:, 20] = [np.nan, 3.0]
    img, xy = _t(img, dev), _t(xy, dev)
    bits = K.pack_bits(img)
    before = K.bilinear_cov_grads.launches
    if with_cov:
        with pytest.raises(ValueError, match="without coverage"):
            K.bilinear_cov_grads(bits, xy, with_grads, with_cov)
        assert K.bilinear_cov_grads.launches == before
        return
    f32 = K.bilinear_cov_grads(img, xy, with_grads, with_cov)
    got = K.bilinear_cov_grads(bits, xy, with_grads, with_cov)
    ref = K.bilinear_cov_grads_plain(bits, xy, with_grads, with_cov)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, f32)
    assert K.bilinear_cov_grads.launches == before + 2


@pytest.mark.parametrize("case", list(bilinear_edge_cases()))
def test_bilinear_kernel_edge_cases(dev, case):
    """NaN, infinite and far points, exact integers, points on and just
    inside each border, H or W of 1, views smaller than a warp, point
    counts that leave a block half full: both image types and all three
    flag sets (the bit mask without coverage) bitwise the plain
    version."""
    img, xy = (_t(a, dev) for a in bilinear_edge_cases()[case])
    for kind, im in bilinear_images(img).items():
        for kw in BILINEAR_MODES:
            if kind == "bits" and kw["with_cov"]:
                continue
            got = K.bilinear_cov_grads(im, xy, **kw)
            ref = K.bilinear_cov_grads_plain(im, xy, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (kind, kw)


def test_bilinear_launch_geometry(dev):
    """The geometry the built kernel reports is the one
    ``launch_geometry`` states, at the main path's two calls and at the
    edge cases' sizes; the wrapper refuses misaligned xy and other image
    types."""
    from bodyfitting_torch.ops.kernels import bilinear

    for BV, N in ((64, 2619), (64, 512), (1, 1), (7, 3), (1, 1025)):
        assert bilinear.kernel_geometry(BV, N) == \
            bilinear.launch_geometry(BV, N)
    img = torch.zeros((1, 8, 8), device=dev)
    xy = torch.zeros(37, device=dev)[1:].view(1, 18, 2)   # 4 bytes off
    with pytest.raises(ValueError, match="boundary"):
        K.bilinear_cov_grads(img, xy)
    with pytest.raises(ValueError, match="float32 or int32"):
        K.bilinear_cov_grads(img.double(), xy.double())
    with pytest.raises(ValueError, match="float32 or int32"):
        K.bilinear_cov_grads(img.to(torch.uint8),
                             torch.zeros((1, 18, 2), device=dev))


def test_contour_match_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    P, M = 700, 2600
    proj = rng.uniform(0, 64, size=(2, M, 2)).astype(np.float32)
    proj[:, 1500:1550] = proj[:, :50]                  # ties across tiles
    contour = np.round(rng.uniform(-5, 70, size=(2, P, 2))).astype(np.float32)
    valid = (rng.random((2, M)) > 0.3).astype(np.float32)
    valid[1] = 0.0                                     # an all-invalid row
    inside = (rng.random((2, M)) > 0.5).astype(np.float32)
    args = [_t(a, dev) for a in (contour, proj, valid, inside)]
    got = K.contour_match_full(*args)
    ref = K.contour_match_full_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[1][1].abs().sum()) == 0
    d2, idx = K.contour_min_idx(*args[:3])
    assert torch.equal(idx, ref[1]) and torch.equal(d2, ref[0])


def test_rows_scatter_kernel_is_deterministic_and_matches_plain(dev):
    rng = np.random.default_rng(2)
    P, M = 512, 2619
    idx = rng.integers(-5, M + 40, size=(4, P)).astype(np.int32)
    idx[:, :60] = 7
    g = rng.normal(size=(4, P, 2)).astype(np.float32)
    idx, g = _t(idx, dev), _t(g, dev)
    before = K.rows_scatter_add.launches
    a = K.rows_scatter_add(idx, g, M)
    b = K.rows_scatter_add(idx, g, M)
    ref = K.rows_scatter_add_plain(idx, g, M)
    torch.cuda.synchronize()
    assert K.rows_scatter_add.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, ref)


@pytest.mark.parametrize("case", list(match_edge_cases(card=True)))
def test_contour_match_kernel_edge_cases(dev, case):
    """Ties at the lane stride, also among invalid candidates; only the last
    candidate valid; M = 1, P = 1; NaN and infinite points; 70,000
    candidates (several shared-memory tiles): all four outputs and
    ``contour_min_idx`` bitwise the plain version."""
    arrays = match_edge_cases(card=True)[case]
    args = [_t(a[None], dev) for a in arrays]
    got = K.contour_match_full(*args)
    ref = K.contour_match_full_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    d2, idx = K.contour_min_idx(*args[:3])
    assert torch.equal(idx, ref[1]) and torch.equal(d2, ref[0])


@pytest.mark.parametrize("case", list(scatter_edge_cases()))
def test_rows_scatter_kernel_edge_cases(dev, case):
    """All entries on one output, negative and out-of-range indices, P = 1,
    M = 1, and rows of several 1,024-entry chunks: bitwise the plain
    version, and launch to launch."""
    idx, g, M = scatter_edge_cases()[case]
    idx = _t(np.stack([idx, idx[::-1].copy()]), dev)
    g = _t(np.stack([g, g[::-1].copy()]), dev)
    a = K.rows_scatter_add(idx, g, M)
    b = K.rows_scatter_add(idx, g, M)
    ref = K.rows_scatter_add_plain(idx, g, M)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, ref)


def test_icp_kernels_launch_geometry(dev):
    """The geometry at the production shape (BV 64, P 512, M 2,619): 128
    contour pixels a block of 512 threads, the row's 2,619 candidates
    staged as 2,688 (21 chunks of 128) float2; one scatter block a row, a
    thread an entry."""
    from bodyfitting_torch.ops.kernels import contour_match, rows_scatter

    assert contour_match.launch_geometry(64, 512, 2619) == dict(
        blocks=256, threads=512, smem_bytes=2688 * 8)
    assert contour_match.launch_geometry(2, 200, 70_000) == dict(
        blocks=4, threads=512, smem_bytes=3072 * 8)
    assert rows_scatter.launch_geometry(64, 512, 2619) == dict(
        blocks=64, threads=512, smem_bytes=512 * 24)
    assert rows_scatter.launch_geometry(1, 3001, 5)["threads"] == 1024


@pytest.mark.parametrize("Q,F", [(3001, 5003), (70, 40000)])
def test_nearest_kernel_matches_plain_and_repeats_bitwise(dev, Q, F):
    """``d2`` bitwise and ``idx`` exactly, on a mesh with repeated faces
    (ties), degenerate faces and queries on the surface; Q and F are no
    multiple of the kernel's 32-query warps or 32-face boxes, and the
    random faces' boxes overlap, so the cull keeps many blocks."""
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(500, 3)).astype(np.float32)
    faces = rng.integers(0, 500, size=(F, 3))
    faces[F // 2:F // 2 + 50] = faces[:50]            # exact ties
    faces[:20, 2] = faces[:20, 1]                     # repeated vertex
    pts = rng.normal(scale=1.5, size=(Q, 3)).astype(np.float32)
    pts[:30] = verts[faces[100:130]].mean(1)          # on the surface
    tri = _t(verts[faces], dev)
    p, v = _t(pts, dev), _t(verts, dev)
    before = K.nearest_d2_idx.launches
    d2a, ia = K.nearest_d2_idx(p, tri, v)
    d2b, ib = K.nearest_d2_idx(p, tri, v)
    ref_d2, ref_i = K.nearest_d2_idx_plain(p, tri, v)
    torch.cuda.synchronize()
    assert K.nearest_d2_idx.launches == before + 2
    assert torch.equal(d2a, d2b) and torch.equal(ia, ib)
    assert torch.equal(d2a, ref_d2) and torch.equal(ia, ref_i)


def test_nearest_kernel_cull_changes_no_result(dev):
    """A closed surface far from the origin (the cull's rounding slack
    scales with the coordinates), its faces repeated (ties across the
    Morton order), queries on faces, on vertices, near and far, one NaN
    query, one face with a NaN corner: ``d2`` bitwise and ``idx`` exactly
    as the plain sweep."""
    from bodyfitting_torch.models.body_model import sphere_mesh
    from chip_smoke import subdivide

    rng = np.random.default_rng(4)
    v, f = sphere_mesh(400, rng)
    v, f = subdivide(v, f.astype(np.int64))
    v = (v * [0.3, 0.9, 0.2] + [40.0, -3.0, 7.0]).astype(np.float32)
    f = np.concatenate([f, f[::-7]])
    tri = v[f]
    tri[11, 2] = np.nan
    pts = (v.mean(0) + rng.normal(scale=0.6, size=(2050, 3))).astype(
        np.float32)
    pts[:200] = v[f[:200]].mean(1)
    pts[200:260] = v[f[300:360, 1]]
    pts[260:300] *= 1.5
    pts[300] = np.nan
    p, t, vv = _t(pts, dev), _t(tri, dev), _t(v, dev)
    d2, idx = K.nearest_d2_idx(p, t, vv)
    ref_d2, ref_i = K.nearest_d2_idx_plain(p, t, vv)
    torch.cuda.synchronize()
    assert torch.equal(d2, ref_d2) and torch.equal(idx, ref_i)


def _mesh_faces(size):
    """A closed sphere-like mesh (12,800 faces) seen by a pinhole camera
    at ``size``², with its hidden back faces, plus the contract's edge
    cases and random small triangles: ``(face_px, face_z)``."""
    from bodyfitting_torch.models.body_model import sphere_mesh
    from chip_smoke import subdivide
    from torch_port_util import edge_case_faces

    rng = np.random.default_rng(5)
    v, f = sphere_mesh(1600, rng)
    v, f = subdivide(v, f.astype(np.int64))
    cam = v + [0.0, 0.0, 3.0]
    px = cam[:, :2] / cam[:, 2:] * (1.2 * size) + size / 2
    face_px, face_z = px[f], cam[f, 2]
    e_px, e_z = edge_case_faces()
    e_px = e_px * (size / 32.0)
    c = rng.uniform(0, size, size=(3000, 1, 2))
    r_px = c + rng.uniform(-3, 3, size=(3000, 3, 2))
    r_z = rng.uniform(0.5, 6.0, size=(3000, 3))
    r_px[1500:1600], r_z[1500:1600] = r_px[:100], r_z[:100]   # ties
    return (np.concatenate([face_px, e_px, r_px]).astype(np.float32),
            np.concatenate([face_z, e_z, r_z]).astype(np.float32))


@pytest.mark.parametrize("size", [37, 128])
def test_raster_kernels_match_plain(dev, size):
    """``rasterize_zbuf`` and ``rasterize_attrs``: depth and attributes
    bitwise, face indices exactly equal to the plain versions, on a mesh
    with back faces, exact duplicates (ties), faces behind and straddling
    the camera, a degenerate face and a NaN corner; F and the image size
    are no multiple of the kernel's 256-face blocks or 16-pixel tiles."""
    px, fz = _mesh_faces(size)
    F = px.shape[0]
    attrs = np.random.default_rng(6).uniform(size=(F, 3, 2)).astype(
        np.float32)
    p, z, a = _t(px, dev), _t(fz, dev), _t(attrs, dev)
    zb, ab = K.rasterize_zbuf.launches, K.rasterize_attrs.launches
    depth, fidx = K.rasterize_zbuf(p, z, size)
    ref_d, ref_i = K.rasterize_zbuf_plain(p, z, size)
    at, fi2, d2 = K.rasterize_attrs(p, z, a, size)
    ref_a, ref_i2, ref_d2 = K.rasterize_attrs_plain(p, z, a, size)
    torch.cuda.synchronize()
    assert K.rasterize_zbuf.launches == zb + 1
    assert K.rasterize_attrs.launches == ab + 1
    assert torch.equal(fidx, ref_i) and torch.equal(depth, ref_d)
    assert torch.equal(fi2, ref_i2) and torch.equal(d2, ref_d2)
    assert torch.equal(at, ref_a)
    assert torch.equal(fi2, fidx)
    assert 0 < int((fidx >= 0).sum()) < size * size


def test_raster_kernels_edge_cases(dev):
    """Only the contract's edge cases, and no faces at all."""
    from torch_port_util import edge_case_faces

    px, fz = (_t(x, dev) for x in edge_case_faces())
    for size in (35, 16, 1):
        depth, fidx = K.rasterize_zbuf(px, fz, size)
        ref = K.rasterize_zbuf_plain(px, fz, size)
        torch.cuda.synchronize()
        assert torch.equal(depth, ref[0]) and torch.equal(fidx, ref[1])
    assert set(torch.unique(fidx).tolist()) <= {-1, 0, 1, 7}
    empty = (torch.zeros((0, 3, 2), device=dev), torch.zeros((0, 3), device=dev))
    depth, fidx = K.rasterize_zbuf(*empty, 20)
    at, fi2, _ = K.rasterize_attrs(*empty, torch.zeros((0, 3, 2), device=dev),
                                   20)
    torch.cuda.synchronize()
    assert (fidx == -1).all() and (fi2 == -1).all() and (at == 0).all()
    assert (depth == K.raster.FAR).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    img = torch.zeros((1, 8, 8), device=dev)
    xy = torch.zeros((1, 4, 2), device=dev)
    with pytest.raises(ValueError):
        K.bilinear_cov_grads(img.double(), xy.double())
    with pytest.raises(ValueError):
        K.bilinear_cov_grads(img, xy.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    with pytest.raises(ValueError):
        K.rows_scatter_add(torch.zeros((1, 4), dtype=torch.int64, device=dev),
                           torch.zeros((1, 4, 2), device=dev), 8)
    with pytest.raises(ValueError, match="22-bit key"):
        K.rows_scatter_add(torch.zeros((1, 4), dtype=torch.int32, device=dev),
                           torch.zeros((1, 4, 2), device=dev), 2 ** 22 - 1)
    with pytest.raises(ValueError):
        K.nearest_d2_idx(torch.zeros((4, 3), dtype=torch.float64, device=dev),
                         torch.zeros((2, 3, 3), dtype=torch.float64,
                                     device=dev))
    with pytest.raises(ValueError):
        K.nearest_d2_idx(torch.zeros((4, 3), device=dev),
                         torch.zeros((2, 9), device=dev))
    px, fz = torch.zeros((2, 3, 2), device=dev), torch.ones((2, 3), device=dev)
    with pytest.raises(ValueError):
        K.rasterize_zbuf(px.double(), fz.double(), 8)
    with pytest.raises(ValueError):
        K.rasterize_zbuf(px.reshape(2, 6), fz, 8)
    with pytest.raises(ValueError):
        K.rasterize_attrs(px, fz, torch.zeros((2, 2, 2), device=dev), 8)
    W = torch.ones((5, 3), device=dev)
    A = torch.ones((1, 3, 12), device=dev)
    vp = torch.ones((1, 5, 3), device=dev)
    with pytest.raises(ValueError):
        K.skin_forward(W.double(), A.double(), vp.double())
    with pytest.raises(ValueError):
        K.skin_forward(W, A, torch.ones((1, 3, 5), device=dev).transpose(1, 2))
    with pytest.raises(ValueError):
        K.skin_forward(torch.ones((5, 65), device=dev),
                       torch.ones((1, 65, 12), device=dev), vp)
    W6 = torch.ones((6, 3), device=dev)[1:]        # 12 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        K.skin_forward(W6, A, vp)
    with pytest.raises(ValueError, match="16-byte"):
        K.skin_backward(W6, A, vp, vp)


@pytest.mark.parametrize("B,V,J", [(1, 10475, 55), (8, 10475, 55),
                                   (8, 251, 55), (1, 300, 24), (3, 1, 55),
                                   (128, 10475, 55), (130, 1031, 64),
                                   (64, 2999, 24), (13, 2999, 24),
                                   (5, 1031, 64)])
def test_skinning_kernels_match_plain_and_repeat_bitwise(dev, B, V, J):
    """Forward, ``dA`` and ``dvp`` bitwise equal to the plain versions
    (``-fmad=false``, the same order), at the full SMPL-X width (one, 8
    and 128 frames), a joints-reduced width (fewer rows than one
    128-vertex tile's multiple), SMPL's 24 joints, 64 joints and one
    vertex, the backward in the geometry it takes by size and in each of
    its two (latency and throughput); frame counts that are no multiple
    of a block's frames, vertex counts that are no multiple of 4 (the W
    tile's tail after its bulk copy); rows of zero weight included.  Two
    backward launches give the same bits (no atomics; the election
    counters are back at 0).  The geometry the kernels report is the one
    ``launch_geometry`` states."""
    rng = np.random.default_rng(B * 7 + V + J)
    W = rng.random((V, J)).astype(np.float32) ** 8
    W /= W.sum(1, keepdims=True)
    W[::11] = 0.0
    A = rng.normal(size=(B, J, 12)).astype(np.float32)
    vp = rng.normal(size=(B, V, 3)).astype(np.float32)
    g = rng.normal(size=(B, V, 3)).astype(np.float32)
    W, A, vp, g = (_t(x, dev) for x in (W, A, vp, g))
    fb, bb = K.skin_forward.launches, K.skin_backward.launches
    out = K.skin_forward(W, A, vp)
    dA1, dvp1 = K.skin_backward(W, A, vp, g)
    dA2, dvp2 = K.skin_backward(W, A, vp, g)
    ref = K.skin_forward_plain(W, A, vp)
    rdA, rdvp = K.skin_backward_plain(W, A, vp, g)
    torch.cuda.synchronize()
    assert K.skin_forward.launches == fb + 1
    assert K.skin_backward.launches == bb + 2
    assert torch.equal(out, ref)
    assert torch.equal(dA1, dA2) and torch.equal(dvp1, dvp2)
    assert torch.equal(dA1, rdA) and torch.equal(dvp1, rdvp)
    for wide in (0, 1):
        dA, dvp = skinning._launch_backward(W, A, vp, g, wide)
        assert torch.equal(dA, rdA) and torch.equal(dvp, rdvp)
    for backward, wide in ((False, -1), (True, -1), (True, 0), (True, 1)):
        assert skinning.kernel_geometry(B, V, J, backward, wide) == \
            skinning.launch_geometry(B, V, J, backward, wide)


def test_skinning_autograd_runs_the_kernels(dev):
    rng = np.random.default_rng(9)
    W = _t(rng.random((700, 55)).astype(np.float32), dev)
    A = _t(rng.normal(size=(2, 55, 12)).astype(np.float32), dev)
    vp = _t(rng.normal(size=(2, 700, 3)).astype(np.float32), dev)
    A.requires_grad_(True)
    vp.requires_grad_(True)
    fb, bb = K.skin_forward.launches, K.skin_backward.launches
    out = K.fused_skinning(W, A, vp)
    dA, dvp = torch.autograd.grad((out ** 2).sum(), [A, vp])
    rdA, rdvp = K.skin_backward_plain(W, A.detach(), vp.detach(),
                                      2 * out.detach())
    torch.cuda.synchronize()
    assert (K.skin_forward.launches, K.skin_backward.launches) == (fb + 1,
                                                                   bb + 1)
    assert torch.equal(dA, rdA) and torch.equal(dvp, rdvp)
