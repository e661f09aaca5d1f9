"""The port's rasterizers (plain versions, the CPU side of the CUDA
kernels) against the JAX package's.

* ``rasterize_zbuf_plain`` / ``rasterize`` against
  ``pallas_kernels.rasterize_pallas(interpret=True)`` and
  ``rz.rasterize``; ``rasterize_attrs_plain`` against
  ``rasterize_attrs_pallas(interpret=True, remap_faces=True)`` and
  ``rasterize_attrs_xla``.  ``face_idx`` exactly on inputs without
  near-ties in depth; depth to rtol 1e-5 and attributes and barycentrics
  to 2e-5 / 1e-5 (the JAX package's own tolerances between its two
  routes: XLA:CPU contracts multiply-adds, and the XLA attribute route
  normalises the weights where the kernel multiplies by the depth).
* The contract's edge cases: faces behind or straddling the camera,
  degenerate faces, a NaN corner, exact duplicates (least caller index
  wins), a face count that is no multiple of a block and an image size
  that is no multiple of 16.
* ``render_attributes``, ``sample_texture`` and ``bilinear_sample_uv``:
  values and texture (and UV) gradients to 1e-5 (summation order of the
  scatter-add and the einsum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.ops import pallas_kernels as pk
from bodyfitting_tpu.ops import rasterize as jrz
from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops import rasterize as trz
from tests.torch_port_util import edge_case_faces


def _faces(seed, F, size, zlo=0.5, zhi=4.0):
    """Random triangles over a ``size``² image: large ones when few, small
    ones (corners within 5 px of a centre) when many."""
    rng = np.random.default_rng(seed)
    if F < 100:
        px = rng.uniform(-4, size + 4, size=(F, 3, 2)).astype(np.float32)
    else:
        c = rng.uniform(-4, size + 4, size=(F, 1, 2))
        px = (c + rng.uniform(-5, 5, size=(F, 3, 2))).astype(np.float32)
    fz = rng.uniform(zlo, zhi, size=(F, 3)).astype(np.float32)
    return px, fz


def _jax_raster(px, fz, size, fb=8):
    return jrz.rasterize(jnp.asarray(px), jnp.asarray(fz), image_size=size,
                         face_block=fb)


@pytest.mark.parametrize("F,size", [(23, 32), (300, 37)])
def test_plain_zbuf_matches_jax_routes(F, size):
    px, fz = _faces(F, F, size)
    ref = _jax_raster(px, fz, size)
    pal = pk.rasterize_pallas(jnp.asarray(px), jnp.asarray(fz), size,
                              pixel_tile=128, face_block=8, interpret=True)
    depth, fidx = K.rasterize_zbuf_plain(torch.tensor(px), torch.tensor(fz),
                                         size)
    assert fidx.dtype == torch.int32 and fidx.shape == (size, size)
    np.testing.assert_array_equal(fidx.numpy(), np.asarray(ref.face_idx))
    np.testing.assert_array_equal(fidx.numpy(), np.asarray(pal.face_idx))
    cov = np.asarray(ref.face_idx) >= 0
    assert 0 < cov.sum() < cov.size
    np.testing.assert_allclose(depth.numpy()[cov], np.asarray(ref.depth)[cov],
                               rtol=1e-5)
    np.testing.assert_allclose(depth.numpy()[cov], np.asarray(pal.depth)[cov],
                               rtol=1e-5)
    assert (depth.numpy()[~cov] == K.raster.FAR).all()
    # the full raster: the same z-buffer and rz.rasterize's post-pass
    out = trz.rasterize(torch.tensor(px), torch.tensor(fz), size)
    np.testing.assert_array_equal(out.face_idx.numpy(), fidx.numpy())
    np.testing.assert_array_equal(out.depth.numpy(), depth.numpy())
    np.testing.assert_allclose(out.bary.numpy(), np.asarray(ref.bary),
                               atol=1e-5)
    assert (out.bary.numpy()[~cov] == 0).all()


@pytest.mark.parametrize("F,size,A", [(23, 32, 2), (300, 37, 3)])
def test_plain_attrs_matches_jax_routes(F, size, A):
    px, fz = _faces(F + 1, F, size)
    attrs = np.random.default_rng(F).uniform(size=(F, 3, A)).astype(
        np.float32)
    j = [jnp.asarray(x) for x in (px, fz, attrs)]
    a_x, f_x, d_x = pk.rasterize_attrs_xla(*j, image_size=size, face_block=8)
    a_p, f_p, d_p = pk.rasterize_attrs_pallas(
        *j, image_size=size, pixel_tile=128, face_block=8, interpret=True,
        remap_faces=True)
    a, f, d = K.rasterize_attrs_plain(*(torch.tensor(x) for x in
                                        (px, fz, attrs)), size)
    assert a.shape == (size, size, A)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_x))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_p))
    cov = np.asarray(f_x) >= 0
    np.testing.assert_allclose(d.numpy()[cov], np.asarray(d_p)[cov], rtol=1e-5)
    np.testing.assert_allclose(d.numpy()[cov], np.asarray(d_x)[cov], rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_p), atol=2e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_x), atol=2e-5)
    assert (a.numpy()[~cov] == 0).all()
    # the wrapper serves CPU tensors with the plain version
    a2, f2, d2 = K.rasterize_attrs(*(torch.tensor(x) for x in
                                     (px, fz, attrs)), size)
    assert torch.equal(a2, a) and torch.equal(f2, f) and torch.equal(d2, d)


def test_zbuf_contract_edge_cases():
    px, fz = edge_case_faces()
    size = 35                                          # not a multiple of 16
    depth, fidx = K.rasterize_zbuf_plain(torch.tensor(px), torch.tensor(fz),
                                         size)
    fidx = fidx.numpy()
    # ties go to the least caller index; nothing behind, straddling,
    # degenerate or NaN wins; the NaN face hides nothing
    assert set(np.unique(fidx)) == {-1, 0, 1, 7}
    keep = [0, 1, 2, 7, 8]
    d2, f2 = K.rasterize_zbuf_plain(torch.tensor(px[keep]),
                                    torch.tensor(fz[keep]), size)
    np.testing.assert_array_equal(fidx, np.where(
        f2.numpy() >= 0, np.array(keep)[f2.numpy()], -1))
    np.testing.assert_array_equal(depth.numpy(), d2.numpy())
    # the JAX routes agree (behind/straddling culled by their front test)
    ref = _jax_raster(px, fz, size)
    np.testing.assert_array_equal(fidx, np.asarray(ref.face_idx))
    # only faces behind the camera: all background
    d3, f3 = K.rasterize_zbuf_plain(torch.tensor(px[3:5]),
                                    torch.tensor(fz[3:5]), size)
    assert (f3.numpy() == -1).all() and (d3.numpy() == K.raster.FAR).all()
    # no faces at all
    d4, f4 = K.rasterize_zbuf_plain(torch.zeros((0, 3, 2)),
                                    torch.zeros((0, 3)), 20)
    assert (f4.numpy() == -1).all() and (d4.numpy() == K.raster.FAR).all()
    a5, f5, _ = K.rasterize_attrs_plain(torch.tensor(px), torch.tensor(fz),
                                        torch.ones((9, 3, 2)), size)
    np.testing.assert_array_equal(f5.numpy(), fidx)
    assert (a5.numpy()[fidx < 0] == 0).all()
    np.testing.assert_allclose(a5.numpy()[fidx >= 0], 1.0, atol=1e-6)


def test_zbuf_plain_chunks_change_no_result(monkeypatch):
    """Many faces in a band, split over several face chunks: the same
    result as one chunk (ties across chunks go to the lower index)."""
    px, fz = _faces(7, 700, 40)
    px[350:400] = px[:50]                              # exact duplicates
    fz[350:400] = fz[:50]
    ref = K.rasterize_zbuf_plain(torch.tensor(px), torch.tensor(fz), 40)
    monkeypatch.setattr(K.raster, "PAIR_BUDGET", 640 * 3)
    got = K.rasterize_zbuf_plain(torch.tensor(px), torch.tensor(fz), 40)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int((ref[1] >= 350).logical_and(ref[1] < 400).sum()) == 0


def test_work_items_cover_every_live_face_box():
    """The kernel's per-face pixel boxes hold every pixel centre of each
    face's bounding box inside the image (a face that cannot win gets
    none), and the prefix sum counts their 8x8 sub-boxes."""
    size = 50
    px, fz = _faces(9, 1000, size)
    fz[:10, 0] = -1.0
    px[10, 1, 0] = np.nan
    px[11] = [[-90.0, -80.0], [200.0, 3.0], [5.0, 300.0]]   # off the image
    box, offsets = K.raster.work_items(torch.tensor(px), torch.tensor(fz),
                                       size, size)
    assert box.dtype == torch.int32 and box.shape == (1000, 4)
    b = box.numpy().astype(np.int64)
    c = np.arange(size) + 0.5
    for j in range(1000):
        fx0, fy0, nx, ny = b[j]
        live = (fz[j] > 1e-9).all() and np.isfinite(px[j]).all()
        if not live:
            assert nx == 0 or ny == 0
            continue
        lo, hi = px[j].min(0), px[j].max(0)
        need_x = np.nonzero((c >= lo[0]) & (c <= hi[0]))[0]
        need_y = np.nonzero((c >= lo[1]) & (c <= hi[1]))[0]
        assert 0 <= fx0 and fx0 + nx <= size and 0 <= fy0 \
            and fy0 + ny <= size
        if need_x.size:
            assert fx0 <= need_x[0] and need_x[-1] < fx0 + nx
        if need_y.size:
            assert fy0 <= need_y[0] and need_y[-1] < fy0 + ny
    subs = (-(-b[:, 2] // 8)) * (-(-b[:, 3] // 8))
    np.testing.assert_array_equal(offsets.numpy(), np.cumsum(subs))
    assert offsets.dtype == torch.int64


def test_project_faces_matches_jax():
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 4.0]
    Kmat = np.array([[50, 0, 16], [0, 55, 17], [0, 0, 1]], np.float32)
    jp, jz = jrz.project_faces(*(jnp.asarray(x) for x in
                                 (verts, faces, w2c, Kmat)))
    tp, tz = trz.project_faces(torch.tensor(verts),
                               torch.tensor(faces).long(),
                               torch.tensor(w2c), torch.tensor(Kmat))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)


def test_render_attributes_and_texture_gradients_match_jax():
    size, F, S = 32, 30, 12
    px, fz = _faces(11, F, size)
    rng = np.random.default_rng(12)
    attrs = rng.normal(size=(F, 3, 3)).astype(np.float32)
    face_uvs = rng.uniform(size=(F, 3, 2)).astype(np.float32)
    tex = rng.uniform(size=(S, S, 3)).astype(np.float32)
    wimg = rng.normal(size=(size, size, 3)).astype(np.float32)

    jr = _jax_raster(px, fz, size)
    tr = trz.rasterize(torch.tensor(px), torch.tensor(fz), size)
    np.testing.assert_array_equal(tr.face_idx.numpy(), np.asarray(jr.face_idx))
    # render_attributes with a background, silhouette and depth maps
    ja = jrz.render_attributes(jr, jnp.asarray(attrs), background=0.25)
    ta = trz.render_attributes(tr, torch.tensor(attrs), background=0.25)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_array_equal(trz.render_silhouette(tr).numpy(),
                                  np.asarray(jrz.render_silhouette(jr)))
    cov = np.asarray(jr.face_idx) >= 0
    np.testing.assert_allclose(trz.render_depth(tr).numpy()[cov],
                               np.asarray(jrz.render_depth(jr))[cov],
                               rtol=1e-5)
    assert (trz.render_depth(tr, 7.0).numpy()[~cov] == 7.0).all()

    # sample_texture: values and the texture gradient of a weighted sum
    def jloss(t):
        return jnp.sum(jrz.sample_texture(jr, jnp.asarray(face_uvs), t, 1.0)
                       * wimg)

    jv = jrz.sample_texture(jr, jnp.asarray(face_uvs), jnp.asarray(tex), 1.0)
    jg = jax.grad(jloss)(jnp.asarray(tex))
    tt = torch.tensor(tex, requires_grad=True)
    tv = trz.sample_texture(tr, torch.tensor(face_uvs), tt, 1.0)
    (tg,) = torch.autograd.grad((tv * torch.tensor(wimg)).sum(), [tt])
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(np.asarray(jg)).max() > 0.1


def test_bilinear_sample_uv_values_and_gradients_match_jax():
    rng = np.random.default_rng(13)
    tex = rng.uniform(size=(9, 14, 2)).astype(np.float32)
    uvs = rng.uniform(-0.2, 1.2, size=(5, 7, 2)).astype(np.float32)
    uvs[0, :3] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.25]]
    w = rng.normal(size=(5, 7, 2)).astype(np.float32)

    def jloss(t, u):
        return jnp.sum(jrz.bilinear_sample_uv(t, u) * w)

    jv = jrz.bilinear_sample_uv(jnp.asarray(tex), jnp.asarray(uvs))
    jgt, jgu = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tex),
                                               jnp.asarray(uvs))
    tt = torch.tensor(tex, requires_grad=True)
    tu = torch.tensor(uvs, requires_grad=True)
    tv = trz.bilinear_sample_uv(tt, tu)
    gt, gu = torch.autograd.grad((tv * torch.tensor(w)).sum(), [tt, tu])
    assert tv.shape == (5, 7, 2)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-5)
    # UVs exactly on a texel (the first three) sit on clip's boundary,
    # where JAX's gradient of ``clip`` halves (max/min tie) and torch's
    # passes; elsewhere the UV gradients agree
    np.testing.assert_allclose(gu.numpy()[0, 3:], np.asarray(jgu)[0, 3:],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gu.numpy()[1:], np.asarray(jgu)[1:],
                               rtol=1e-5, atol=1e-4)


def test_texture_gradient_sums_colliding_taps_in_position_order():
    """The gather's backward adds the cotangent rows that share a texel in
    ascending position, on every device: here bitwise ``np.add.at``'s
    sequential sum (autograd's own CPU scatter-add, ``index_put_`` with
    ``accumulate``, takes another order at this size in PyTorch 2.13)."""
    rng = np.random.default_rng(14)
    rows, n = 7000, 20000
    idx = rng.integers(0, rows, size=n)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    table = torch.zeros((rows, 3), requires_grad=True)
    (got,) = torch.autograd.grad(
        trz._Gather.apply(table, torch.as_tensor(idx)), table,
        torch.as_tensor(g))
    ref = np.zeros((rows, 3), np.float32)
    np.add.at(ref, idx, g)
    np.testing.assert_array_equal(got.numpy(), ref)
