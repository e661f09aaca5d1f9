"""The port's nearest point-on-mesh query against the JAX package's.

Routes held against each other on the CPU:
  * ``closest_point_on_triangles`` against JAX's, run op by op (eager,
    so no fused multiply-add): 1e-6 absolute on coordinates of order 1,
    since the two sum each dot product over xyz in their own order;
  * ``nearest_d2_idx_plain`` (the kernel's plain version) and
    ``nearest_point_on_mesh`` against the Pallas kernel in interpret mode
    (``tie_break=True``, ``query_tile=16, face_block=32``) and against
    ``bodyfitting_tpu.ops.nearest.nearest_point_on_mesh``: ``idx``
    exactly; ``d2`` within 4 eps (d2 + diag²), a few ulp of the scale at
    which the distances are computed (XLA:CPU fuses multiply-adds, the
    port rounds every operation, and the closest point's coordinates
    carry the mesh's scale).

Faces with a repeated vertex are left out of the comparison with the
JAX package: there its jit-compiled route contracts ``d1 d4 - d3 d2``
into a fused multiply-add, the Voronoi weights of a collapsed face are
then not exactly 0 and the query can land in the interior branch with a
1/tiny weight (ROADMAP §3).  On such faces the port is held to JAX's
op-by-op route and to a float64 lower bound instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.ops import nearest as jn
from bodyfitting_tpu.ops import pallas_kernels as pk
from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops import nearest as tn
from bodyfitting_torch.ops.kernels.nearest import tri_dist2

EPS32 = float(np.finfo(np.float32).eps)


def _distinct_faces(rng, n, nv):
    """Random faces with three distinct vertices each."""
    a = rng.integers(0, nv, size=n)
    b = (a + 1 + rng.integers(0, nv - 1, size=n)) % nv
    c = (a + 1 + rng.integers(0, nv - 2, size=n)) % nv
    c = np.where(c == b, (c + 1) % nv, c)
    c = np.where(c == a, (c + 1) % nv, c)
    faces = np.stack([a, b, c], 1).astype(np.int32)
    assert (faces[:, 0] != faces[:, 1]).all()
    assert (faces[:, 1] != faces[:, 2]).all()
    assert (faces[:, 0] != faces[:, 2]).all()
    return faces


def _mesh_and_queries(seed, Q=203, F=301, nv=50):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(nv, 3)).astype(np.float32)
    faces = _distinct_faces(rng, F, nv)
    pts = rng.normal(scale=1.5, size=(Q, 3)).astype(np.float32)
    # queries on the surface: face centroids and corners
    pts[:10] = verts[faces[10:20]].mean(1)
    pts[10:15] = verts[faces[30:35, 1]]
    return verts, faces, pts


def _d2_tol(d2, verts):
    ext = verts.max(0) - verts.min(0)
    return 4 * EPS32 * (np.asarray(d2) + float((ext * ext).sum()))


def _seg_dist2_f64(p, a, b):
    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-300), 0.0, 1.0)
    return float(np.sum((p - (a + t * ab)) ** 2))


def test_closest_point_on_triangles_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(scale=1.5, size=(64, 1, 3)).astype(np.float32)
    tri = rng.normal(size=(1, 40, 3, 3)).astype(np.float32)
    got = tn.closest_point_on_triangles(
        *(torch.tensor(x) for x in (p, tri[..., 0, :], tri[..., 1, :],
                                    tri[..., 2, :])))
    ref = jn.closest_point_on_triangles(
        *(jnp.asarray(x) for x in (p, tri[..., 0, :], tri[..., 1, :],
                                   tri[..., 2, :])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_closest_point_single_triangle_analytic():
    a = torch.tensor([0.0, 0.0, 0.0])
    b = torch.tensor([1.0, 0.0, 0.0])
    c = torch.tensor([0.0, 1.0, 0.0])
    cases = [
        ([0.25, 0.25, 1.0], [0.25, 0.25, 0.0]),     # interior, above
        ([-1.0, -1.0, 0.5], [0.0, 0.0, 0.0]),       # vertex a
        ([2.0, -0.5, 0.0], [1.0, 0.0, 0.0]),        # vertex b
        ([-0.3, 3.0, 0.0], [0.0, 1.0, 0.0]),        # vertex c
        ([0.5, -1.0, 0.0], [0.5, 0.0, 0.0]),        # edge ab
        ([-1.0, 0.5, 2.0], [0.0, 0.5, 0.0]),        # edge ac
        ([1.0, 1.0, 0.0], [0.5, 0.5, 0.0]),         # edge bc
    ]
    for p, want in cases:
        got = tn.closest_point_on_triangles(torch.tensor(p), a, b, c)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7, err_msg=p)
    d2, idx = K.nearest_d2_idx_plain(torch.tensor([[0.25, 0.25, 1.0]]),
                                     torch.stack([a, b, c])[None])
    assert float(d2[0]) == 1.0 and int(idx[0]) == 0


def test_degenerate_faces_give_finite_distances():
    """Zero-area faces (a repeated vertex, or all three equal) are real in
    scans.  Their distances stay finite (the 1e-30 floor of safe_div),
    every returned point lies on the collapsed face, so no distance is
    below the float64 distance to it, and the port's closest points equal
    JAX's run op by op.  (The region rules do not always find the
    nearest point of a collapsed face: with a == b the "edge ab" rule
    fires and returns a, in both packages.)"""
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = _distinct_faces(rng, 40, 30)
    faces[:10, 2] = faces[:10, 1]                 # b == c: segment ab
    faces[10:20, 0] = faces[10:20, 2]             # a == c: segment ab
    faces[20:25, 1] = faces[20:25, 0]             # a == b: segment ac
    faces[25:30] = faces[25:30, :1]               # a point
    pts = rng.normal(scale=1.5, size=(60, 3)).astype(np.float32)
    tri = verts[faces[:30]]
    d2 = tri_dist2(torch.tensor(pts)[:, None], torch.tensor(tri)[None])
    assert torch.isfinite(d2).all()
    for qi in range(len(pts)):
        for fi in range(30):
            t = tri[fi].astype(np.float64)
            ends = (t[0], t[2]) if 20 <= fi < 25 else (t[0], t[1])
            want = _seg_dist2_f64(pts[qi].astype(np.float64), *ends)
            assert float(d2[qi, fi]) >= want * (1 - 1e-5) - 1e-6, (qi, fi)
    args = (pts[:, None], tri[None, :, 0], tri[None, :, 1], tri[None, :, 2])
    got = tn.closest_point_on_triangles(*(torch.tensor(x) for x in args))
    ref = jn.closest_point_on_triangles(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # the sweep over the whole mesh, degenerate faces included
    got_d2, got_idx = K.nearest_d2_idx_plain(torch.tensor(pts),
                                             torch.tensor(verts[faces]))
    assert torch.isfinite(got_d2).all()
    assert ((got_idx >= 0) & (got_idx < len(faces))).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_matches_both_jax_routes(seed):
    verts, faces, pts = _mesh_and_queries(seed)
    tri = verts[faces]
    d2_pk, idx_pk = pk.nearest_d2_idx(
        jnp.asarray(pts), jnp.asarray(tri), query_tile=16, face_block=32,
        interpret=True, tie_break=True, tie_verts=jnp.asarray(verts))
    pt_x, idx_x, d2_x = jn.nearest_point_on_mesh(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces))
    d2, idx = K.nearest_d2_idx_plain(torch.tensor(pts), torch.tensor(tri),
                                     torch.tensor(verts))
    pt, idx2, d2b = tn.nearest_point_on_mesh(
        torch.tensor(pts), torch.tensor(verts), torch.tensor(faces))
    assert torch.equal(idx, idx2) and torch.equal(d2, d2b)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_pk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    for ref in (d2_pk, d2_x):
        err = np.abs(d2.numpy() - np.asarray(ref))
        assert (err <= _d2_tol(ref, verts)).all(), err.max()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pt_x), rtol=0,
                               atol=1e-5)
    # queries on the surface are at distance ~0
    assert (d2.numpy()[:15] <= _d2_tol(0.0, verts)).all()


def test_nearest_tie_on_shared_edge_takes_lowest_face():
    """A query in a shared edge's Voronoi region is equidistant from both
    incident faces; the higher-index face is listed first and the faces
    repeat, so visiting order and block layout differ between routes.
    Every route returns face 0."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, -1], [0.5, -1, -1]],
                     np.float32)
    faces = np.array([[0, 1, 3], [0, 1, 2], [0, 1, 3], [0, 1, 2]], np.int32)
    pts = np.array([[0.5, 0.0, 1.0]], np.float32)
    _, idx_x, _ = jn.nearest_point_on_mesh(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces),
        face_block=2)
    _, idx_pk = pk.nearest_d2_idx(
        jnp.asarray(pts), jnp.asarray(verts[faces]), query_tile=8,
        face_block=2, interpret=True, tie_break=True,
        tie_verts=jnp.asarray(verts))
    for fb in (1, 2, 512):
        _, idx = K.nearest_d2_idx_plain(torch.tensor(pts),
                                        torch.tensor(verts[faces]),
                                        torch.tensor(verts), face_block=fb)
        assert int(idx[0]) == int(idx_x[0]) == int(idx_pk[0]) == 0


def test_nearest_points_stops_gradients_at_the_mesh():
    verts, faces, pts = _mesh_and_queries(2, Q=40, F=60)
    p = torch.tensor(pts, requires_grad=True)
    v = torch.tensor(verts, requires_grad=True)
    closest, idx = tn.nearest_points(p, v, torch.tensor(faces))
    assert not closest.requires_grad and idx.dtype == torch.int32
    loss = ((p - closest) ** 2).sum()
    (g,) = torch.autograd.grad(loss, [p])
    np.testing.assert_allclose(g.numpy(), 2 * (pts - closest.numpy()),
                               rtol=1e-6, atol=1e-6)
    # JAX's nearest_points: the same closest points and gradient
    import jax

    def jloss(q):
        c, _ = jn.nearest_points(q, jnp.asarray(verts), jnp.asarray(faces))
        return jnp.sum((q - c) ** 2)

    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(pts))),
        rtol=0, atol=1e-5)
