"""The port's distance volume and scan losses against the JAX package's.

Tolerances:
  * the volume at R=24 on a 156-face convex hull: ``face_idx`` exactly
    (both routes apply the same tie rule); ``dist`` within 4 eps of the
    mesh's scale (XLA:CPU fuses multiply-adds, the port does not);
  * ``query_distance`` against JAX's hinge-matmul form and its gather
    oracle: 2e-6 on values of order 1 and 2e-5 on gradients, the
    reassociation of 8 taps in f32.  Points at integer grid coordinates
    are left out, where the hinge's autodiff takes another subgradient;
  * ``query_nearest_face`` exactly;
  * the mesh losses and their gradients: 1e-5 relative in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.losses import mesh as jmesh
from bodyfitting_tpu.ops import sdf as jsdf
from bodyfitting_torch.convert import distance_volume_from_numpy
from bodyfitting_torch.losses import mesh as tmesh
from bodyfitting_torch.ops import sdf as tsdf
from tests.torch_port_util import arrays_of

R = 24
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def hull():
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(80, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    faces = ConvexHull(pts).simplices.astype(np.int32)
    return pts.astype(np.float32), faces


@pytest.fixture(scope="module")
def volumes(hull):
    verts, faces = hull
    jv = jsdf.build_distance_volume(jnp.asarray(verts), jnp.asarray(faces),
                                    resolution=R)
    tv = tsdf.build_distance_volume(torch.tensor(verts),
                                    torch.tensor(faces), resolution=R)
    return jv, tv


def _off_grid_points(vol, rng, n, lo=-2.0, hi=2.0):
    """Points whose grid coordinates are at least 1e-3 from an integer."""
    pts = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    g = (pts - np.asarray(vol.origin)) / float(vol.spacing)
    ok = (np.abs(g - np.round(g)) > 1e-3).all(1)
    return pts[ok]


def test_build_distance_volume_matches_jax(hull, volumes):
    verts, _ = hull
    jv, tv = volumes
    assert tv.dist.shape == (R, R, R) and tv.face_idx.dtype == torch.int32
    np.testing.assert_array_equal(tv.face_idx.numpy(),
                                  np.asarray(jv.face_idx))
    np.testing.assert_array_equal(tv.origin.numpy(), np.asarray(jv.origin))
    assert float(tv.spacing) == float(jv.spacing)
    diag2 = float(np.sum(np.ptp(verts, 0) ** 2))
    # |sqrt(a) - sqrt(b)| <= |a - b| / (sqrt(a) + sqrt(b)); both d2 agree
    # to 4 eps (d2 + diag2)
    d_t, d_j = tv.dist.numpy(), np.asarray(jv.dist)
    tol = 4 * EPS32 * (d_j ** 2 + diag2) / np.maximum(d_t + d_j, 1e-3)
    assert (np.abs(d_t - d_j) <= tol + 1e-6).all()


def test_query_distance_matches_jax_values_and_gradients(volumes):
    jv, tv = volumes
    rng = np.random.default_rng(1)
    pts = _off_grid_points(jv, rng, 600)           # many outside the grid
    g = (pts - np.asarray(jv.origin)) / float(jv.spacing)
    assert ((g < 0) | (g > R - 1)).any(1).sum() > 50
    p = torch.tensor(pts, requires_grad=True)
    d = tsdf.query_distance(tv, p)
    (gt,) = torch.autograd.grad(d.sum(), [p])
    for fn in (jsdf.query_distance, jsdf._query_distance_gather):
        dj = np.asarray(fn(jv, jnp.asarray(pts)))
        gj = np.asarray(jax.grad(lambda q: fn(jv, q).sum())(jnp.asarray(pts)))
        np.testing.assert_allclose(d.detach().numpy(), dj, rtol=0, atol=2e-6)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=2e-5)


def test_query_nearest_face_matches_jax(volumes):
    jv, tv = volumes
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    # grid coordinates at exact halves: jnp.round and torch.round both
    # round half to even
    pts[:20] = (np.asarray(jv.origin) + float(jv.spacing)
                * (np.arange(20)[:, None] % 7 + 0.5)).astype(np.float32)
    got = tsdf.query_nearest_face(tv, torch.tensor(pts))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsdf.query_nearest_face(jv, jnp.asarray(pts))))


def test_sdf_losses_match_jax(hull, volumes):
    verts, faces = hull
    jv, tv = volumes
    rng = np.random.default_rng(3)
    pts = _off_grid_points(jv, rng, 300, -1.3, 1.3)
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    sfn = np.asarray(jmesh.compute_face_normals(jnp.asarray(verts),
                                                jnp.asarray(faces)))
    p = torch.tensor(pts, requires_grad=True)
    n = torch.tensor(nrm, requires_grad=True)
    pc = tsdf.point_cloud_loss_sdf(p, tv)
    nl = tsdf.normal_loss_sdf(p, n, tv, torch.tensor(sfn))
    gp, gn = torch.autograd.grad(pc + nl, [p, n])
    jpc = lambda q: jsdf.point_cloud_loss_sdf(q, jv)  # noqa: E731
    jnl = lambda q, m: jsdf.normal_loss_sdf(  # noqa: E731
        q, m, jv, jnp.asarray(sfn))
    jp, jn_ = jnp.asarray(pts), jnp.asarray(nrm)
    np.testing.assert_allclose(float(pc.detach()), float(jpc(jp)), rtol=1e-5)
    np.testing.assert_allclose(float(nl.detach()), float(jnl(jp, jn_)),
                               rtol=1e-5)
    jgp, jgn = jax.grad(lambda q, m: jpc(q) + jnl(q, m),
                        argnums=(0, 1))(jp, jn_)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=0,
                               atol=1e-5 * float(np.abs(jgp).max()))
    np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), rtol=0,
                               atol=1e-7)


def test_distance_volume_from_numpy_carries_the_jax_volume(volumes):
    jv, tv = volumes
    got = distance_volume_from_numpy(arrays_of(jv), device="cpu")
    assert got.dist.shape == (1, R, R, R)
    assert got.face_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.face_idx[0].numpy(),
                                  np.asarray(jv.face_idx))
    assert float(got.spacing[0]) == float(jv.spacing)


def _body_mesh():
    """A closed body-like mesh with sliver-free faces, plus one
    degenerate (repeated-vertex) face appended."""
    from bodyfitting_torch.models.body_model import sphere_mesh

    verts, faces = sphere_mesh(120, np.random.default_rng(4))
    faces = np.concatenate([faces, faces[:1, [0, 0, 1]]]).astype(np.int32)
    return verts.astype(np.float32), faces


def test_vertex_and_face_normals_match_jax():
    verts, faces = _body_mesh()
    rng = np.random.default_rng(5)
    w = rng.normal(size=verts.shape).astype(np.float32)
    v = torch.tensor(verts, requires_grad=True)
    vn = tmesh.compute_vertex_normals(v, torch.tensor(faces))
    (g,) = torch.autograd.grad((vn * torch.tensor(w)).sum(), [v])
    assert torch.isfinite(g).all()              # the degenerate face too
    jvn = jmesh.compute_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    jg = jax.grad(lambda x: jnp.sum(jmesh.compute_vertex_normals(
        x, jnp.asarray(faces)) * w))(jnp.asarray(verts))
    np.testing.assert_allclose(vn.detach().numpy(), np.asarray(jvn),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(jg).max()))
    fn = tmesh.compute_face_normals(torch.tensor(verts), torch.tensor(faces))
    np.testing.assert_allclose(
        fn.numpy(), np.asarray(jmesh.compute_face_normals(
            jnp.asarray(verts), jnp.asarray(faces))), rtol=0, atol=1e-7)


def test_exact_mesh_losses_match_jax():
    verts, faces = _body_mesh()
    scan_v, scan_f = verts * 1.05, faces[:-1]
    rng = np.random.default_rng(6)
    pts = (verts + rng.normal(scale=0.02, size=verts.shape)).astype(
        np.float32)
    sfn = np.asarray(jmesh.compute_face_normals(jnp.asarray(scan_v),
                                                jnp.asarray(scan_f)))
    tf = torch.tensor(faces)

    def t_losses(p):
        vn = tmesh.compute_vertex_normals(p, tf)
        return (tmesh.point_cloud_loss(p, torch.tensor(scan_v),
                                       torch.tensor(scan_f)),
                tmesh.normal_loss(p, vn, torch.tensor(scan_v),
                                  torch.tensor(scan_f), torch.tensor(sfn)),
                tmesh.normal_laplacian_smoothness(vn, tf))

    def j_losses(p):
        vn = jmesh.compute_vertex_normals(p, jnp.asarray(faces))
        args = (jnp.asarray(scan_v), jnp.asarray(scan_f))
        return (jmesh.point_cloud_loss(p, *args),
                jmesh.normal_loss(p, vn, *args, jnp.asarray(sfn)),
                jmesh.normal_laplacian_smoothness(vn, jnp.asarray(faces)))

    p = torch.tensor(pts, requires_grad=True)
    got = t_losses(p)
    ref = j_losses(jnp.asarray(pts))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a.detach()), float(b),
                                   rtol=1e-5)
    (g,) = torch.autograd.grad(sum(got), [p])
    jg = jax.grad(lambda q: sum(j_losses(q)))(jnp.asarray(pts))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(jg).max()))
