"""The port's rotations, camera ops, geometry, soft silhouette, mesh
queries and chamfer distance against the JAX package's, on the CPU.

Tolerances (f32 unless stated):
  * rotations and cameras: 2e-6 absolute on unit-scale values (other
    operation orders in f32), gradients 1e-5 of the largest entry;
    ``adjust_intrinsics_for_crop`` rtol 1e-7 (the same f32 operations);
  * translation estimate: rtol 1e-4 (a 3x3 solve of normal equations
    whose entries reach ~1e10 in f32);
  * soft silhouette: coverage 2e-5 absolute, vertex gradients 1e-4 of
    the largest entry (other summation orders over faces);
  * inside-mesh and intersects-any: exactly equal, on points and rays
    kept away from edges and vertices (XLA:CPU contracts multiply-adds);
  * chamfer: 1e-6 relative on the value, 1e-5 of the largest gradient
    entry, on the sample indices JAX's ``chamfer_loss`` draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.losses import mesh as jmesh
from bodyfitting_tpu.ops import camera as jcam
from bodyfitting_tpu.ops import geometry as jgeo
from bodyfitting_tpu.ops import mesh_queries as jmq
from bodyfitting_tpu.ops import rasterize as jrz
from bodyfitting_tpu.ops import rotations as jrot
from bodyfitting_torch.losses import mesh as tmesh
from bodyfitting_torch.ops import camera as tcam
from bodyfitting_torch.ops import geometry as tgeo
from bodyfitting_torch.ops import mesh_queries as tmq
from bodyfitting_torch.ops import rasterize as trz
from bodyfitting_torch.ops import rotations as trot


def _rotations(n, seed=0, min_angle=0.2):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(min_angle, np.pi - 0.05, size=(n, 1))
    aa = (axis * angle).astype(np.float32)
    return aa, np.asarray(jrot.rodrigues(jnp.asarray(aa)))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rotmat_to_rot6d", "rotmat_to_quat",
                                "rotmat_to_aa"])
def test_rotmat_conversions_match_jax(fn):
    _, R = _rotations(64)
    # every pivot branch: the identity, 180-degree turns about each axis
    # (trace -1: the largest diagonal picks the branch), near-ties
    extra = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1, -1]),
             np.diag([-1.0, -1.0, 1.0])]
    R = np.concatenate([R, np.asarray(extra, np.float32)]).astype(np.float32)
    got = getattr(trot, fn)(torch.from_numpy(R)).numpy()
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(R)))
    _close(got, want, 2e-6)


def test_quat_to_aa_matches_jax_and_is_safe_at_zero():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = np.concatenate([q, [[1.0, 0, 0, 0], [1.0, 1e-9, 0, 0]]]).astype(
        np.float32)
    got = trot.quat_to_aa(torch.from_numpy(q)).numpy()
    _close(got, np.asarray(jrot.quat_to_aa(jnp.asarray(q))), 2e-6)
    # below _EPS the safe divide's first-order 2 xyz
    np.testing.assert_array_equal(got[-1], 2.0 * q[-1, 1:])


def test_rotmat_to_aa_gradients_match_jax():
    _, R = _rotations(16, seed=2, min_angle=0.5)
    w = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    jg = jax.grad(lambda m: jnp.sum(jrot.rotmat_to_aa(m) * w))(
        jnp.asarray(R))
    Rt = torch.from_numpy(R).requires_grad_(True)
    (trot.rotmat_to_aa(Rt) * torch.from_numpy(w)).sum().backward()
    g = Rt.grad.numpy()
    _close(g, jg, 1e-5 * np.abs(np.asarray(jg)).max())


def test_rotmat_to_aa_np_and_torch_agree():
    aa, R = _rotations(32, seed=4)
    got = trot.rotmat_to_aa(torch.from_numpy(R)).numpy()
    _close(got, trot.rotmat_to_aa_np(R), 2e-6)
    _close(got, aa, 1e-5)


def test_host_rodrigues_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    vecs = list(rng.normal(size=(20, 3)))
    vecs += [np.zeros(3), np.array([np.pi, 0, 0]), np.array([0, -np.pi, 0]),
             np.array([0.0, 0.0, 1e-20])]
    for r in vecs:
        R = trot.rodrigues_np(r)
        np.testing.assert_allclose(R, cv2.Rodrigues(r)[0], atol=1e-15)
        back = trot.rotmat_to_aa_f64_np(R)
        np.testing.assert_allclose(back, cv2.Rodrigues(R)[0][:, 0],
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def test_world_to_camera_and_invert_rigid_match_jax():
    _, R = _rotations(5, seed=6)
    rng = np.random.default_rng(6)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    got = tcam.world_to_camera(*map(torch.from_numpy, (pts, R, t))).numpy()
    _close(got, jcam.world_to_camera(pts, R, t), 2e-6)
    T = np.zeros((5, 4, 4), np.float32)
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, t, 1.0
    inv = tcam.invert_rigid(torch.from_numpy(T)).numpy()
    _close(inv, jcam.invert_rigid(jnp.asarray(T)), 2e-6)
    _close(inv @ T, np.broadcast_to(np.eye(4), T.shape), 2e-6)


def test_adjust_intrinsics_for_crop_matches_jax():
    K = np.array([[1500.0, 0, 1224], [0, 1500.0, 1024], [0, 0, 1]])
    got = tcam.adjust_intrinsics_for_crop(K, 100, 300, 1700, 1900, 512)
    want = jcam.adjust_intrinsics_for_crop(K, 100, 300, 1700, 1900, 512)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
    Kb = np.stack([K, K * 1.1, K * 0.9]).astype(np.float32)
    Kb[:, 2, 2] = 1.0
    box = [np.array(v, np.float32) for v in
           ([100, 50, 0], [300, 10, 7], [1700, 1100, 900], [1900, 1060, 907])]
    got = tcam.adjust_intrinsics_for_crop(Kb, *box, 368)
    want = jcam.adjust_intrinsics_for_crop(Kb, *map(jnp.asarray, box), 368)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_look_at_and_ring_cameras_match_jax():
    center = np.array([0.1, 0.9, -0.2], np.float32)
    got = tcam.ring_cameras(8, torch.from_numpy(center), 2.5, height=0.3)
    want = jcam.ring_cameras(8, jnp.asarray(center), 2.5, height=0.3)
    _close(got.numpy(), want, 3e-6)
    eye = np.array([[1.0, 2.0, 3.0], [-2.0, 0.5, 1.0]], np.float32)
    up = np.array([[0.0, 1.0, 0.0]] * 2, np.float32)
    c = np.zeros((2, 3), np.float32)
    got = tcam.look_at_extrinsics(*map(torch.from_numpy, (eye, c, up)))
    _close(got.numpy(), jcam.look_at_extrinsics(eye, c, up), 2e-6)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def test_estimate_translation_matches_jax():
    rng = np.random.default_rng(7)
    B, J = 3, 49
    S = rng.normal(scale=0.3, size=(B, J, 3)).astype(np.float32)
    t_true = np.array([0.1, -0.2, 40.0], np.float32)
    P = S + t_true
    uv = 5000.0 * P[..., :2] / P[..., 2:] + 112.0
    conf = rng.uniform(0.2, 1.0, size=(B, J, 1))
    conf[:, :3] = 0.0
    j2d = np.concatenate([uv, conf], -1).astype(np.float32)
    for gt_only in (True, False):
        got = tgeo.estimate_translation(torch.from_numpy(S),
                                        torch.from_numpy(j2d),
                                        use_gt_joints_only=gt_only).numpy()
        want = np.asarray(jgeo.estimate_translation(
            jnp.asarray(S), jnp.asarray(j2d), use_gt_joints_only=gt_only))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, np.broadcast_to(t_true, got.shape),
                                   rtol=1e-3)


def test_crop_translation_transfers_match_jax():
    K = np.array([[1400.0, 0, 1000], [0, 1400.0, 800], [0, 0, 1]],
                 np.float32)
    cam_t = np.array([0.05, -0.1, 45.0], np.float32)
    cc = np.array([900.0, 700.0], np.float32)
    args = (1.3, cc, 4.2, K)
    g = tgeo.crop_to_global_translation(torch.from_numpy(cam_t), 1.3,
                                        torch.from_numpy(cc), 4.2,
                                        torch.from_numpy(K))
    want = jgeo.crop_to_global_translation(jnp.asarray(cam_t), *args)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    back = tgeo.global_to_crop_translation(g, 1.3, torch.from_numpy(cc),
                                           4.2, torch.from_numpy(K))
    want = jgeo.global_to_crop_translation(jnp.asarray(want), *args)
    np.testing.assert_allclose(back.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(back.numpy(), cam_t, rtol=1e-5)


# ---------------------------------------------------------------------------
# Soft silhouette
# ---------------------------------------------------------------------------

def _octahedron():
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], np.float32) * 0.5
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def _soft_inputs():
    v, f = _octahedron()
    rot = trot.rodrigues_np([0.3, 0.5, -0.2]).astype(np.float32)
    v = v @ rot.T
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    return v, f, w2c, K


@pytest.mark.parametrize("sigma", [1e-4, 1e-3])
def test_soft_silhouette_matches_jax(sigma):
    v, f, w2c, K = _soft_inputs()
    wts = np.random.default_rng(8).normal(size=(32, 32)).astype(np.float32)

    def jloss(verts):
        px, fz = jrz.project_faces(verts, jnp.asarray(f), w2c, K)
        cov = jrz.soft_silhouette(px, 32, sigma=sigma, face_z=fz)
        return jnp.sum(cov * wts), cov

    (_, jcov), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    px, fz = trz.project_faces(vt, torch.from_numpy(f).long(),
                               torch.from_numpy(w2c), torch.from_numpy(K))
    cov = trz.soft_silhouette(px, 32, sigma=sigma, face_z=fz, face_block=3)
    (cov * torch.from_numpy(wts)).sum().backward()
    _close(cov.detach().numpy(), jcov, 2e-5)
    assert float(cov.detach().max()) > 0.5
    jg = np.asarray(jg)
    _close(vt.grad.numpy(), jg, 1e-4 * np.abs(jg).max())


def test_soft_silhouette_skips_far_tiles_exactly():
    """At 96² the mesh covers the middle: the corner tiles have no face
    near them and stay 0, as every face's contribution underflows there
    in JAX too; values and gradients match JAX's dense sum."""
    v, f, w2c, K = _soft_inputs()
    K = K.copy()
    K[:2, 2] = 48.0
    wts = np.random.default_rng(9).normal(size=(96, 96)).astype(np.float32)

    def jloss(verts):
        px, fz = jrz.project_faces(verts, jnp.asarray(f), w2c, K)
        cov = jrz.soft_silhouette(px, 96, face_z=fz)
        return jnp.sum(cov * wts), cov

    (_, jcov), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    px, fz = trz.project_faces(vt, torch.from_numpy(f).long(),
                               torch.from_numpy(w2c), torch.from_numpy(K))
    cov = trz.soft_silhouette(px, 96, face_z=fz)
    (cov * torch.from_numpy(wts)).sum().backward()
    _close(cov.detach().numpy(), jcov, 2e-5)
    assert float(cov[:8, :8].abs().max()) == 0.0 == float(
        np.abs(np.asarray(jcov)[:8, :8]).max())
    jg = np.asarray(jg)
    _close(vt.grad.numpy(), jg, 1e-4 * np.abs(jg).max())


def test_soft_silhouette_culls_faces_at_the_camera_plane():
    v, f, w2c, K = _soft_inputs()
    px, fz = trz.project_faces(torch.from_numpy(v), torch.from_numpy(f).long(),
                               torch.from_numpy(w2c), torch.from_numpy(K))
    fz = fz.clone()
    fz[:4, 0] = 0.0                                  # four faces culled
    got = trz.soft_silhouette(px, 32, face_z=fz)
    want = jrz.soft_silhouette(jnp.asarray(px.numpy()), 32,
                               face_z=jnp.asarray(fz.numpy()))
    _close(got.numpy(), want, 2e-5)
    only = trz.soft_silhouette(px[4:], 32)
    _close(got.numpy(), only.numpy(), 2e-5)


def test_soft_silhouette_block_does_not_change_the_result():
    v, f, w2c, K = _soft_inputs()
    px, fz = trz.project_faces(torch.from_numpy(v).double(),
                               torch.from_numpy(f).long(),
                               torch.from_numpy(w2c).double(),
                               torch.from_numpy(K).double())
    a = trz.soft_silhouette(px, 24, face_z=fz, face_block=1)
    b = trz.soft_silhouette(px, 24, face_z=fz)
    _close(a.numpy(), b.numpy(), 1e-12)


# ---------------------------------------------------------------------------
# Mesh queries
# ---------------------------------------------------------------------------

def _sphere(n=200, seed=9):
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    hull = ConvexHull(p)
    return p.astype(np.float32), hull.simplices.astype(np.int32)


def test_inside_mesh_matches_jax():
    v, f = _sphere()
    rng = np.random.default_rng(10)
    r = np.concatenate([rng.uniform(0.0, 0.8, 150),
                        rng.uniform(1.2, 2.0, 150)])
    d = rng.normal(size=(300, 3))
    q = (d / np.linalg.norm(d, axis=1, keepdims=True) * r[:, None]).astype(
        np.float32)
    got = tmq.inside_mesh(*map(torch.from_numpy, (q, v, f)), face_block=37)
    want = np.asarray(jmq.inside_mesh(q, v, f))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), r < 1.0)
    auto = tmq.inside_mesh(*map(torch.from_numpy, (q, v, f)))
    np.testing.assert_array_equal(auto.numpy(), want)


def test_intersects_any_matches_jax():
    v, f = _sphere()
    rng = np.random.default_rng(11)
    o = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    got = tmq.intersects_any(*map(torch.from_numpy, (o, d, v, f)),
                             face_block=50)
    want = np.asarray(jmq.intersects_any(o, d, v, f))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < len(o)


# ---------------------------------------------------------------------------
# Chamfer
# ---------------------------------------------------------------------------

def test_chamfer_from_samples_matches_jax_chamfer_loss():
    rng = np.random.default_rng(12)
    src = rng.normal(size=(4, 50, 3)).astype(np.float32)
    tar = rng.normal(size=(333, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, jg = jax.value_and_grad(jmesh.chamfer_loss)(
        jnp.asarray(src), jnp.asarray(tar), key, 64)
    # the indices chamfer_loss draws, computed as it computes them
    k1, k2 = jax.random.split(key)
    si = np.asarray(jax.random.randint(k1, (64,), 0, 200))
    ti = np.asarray(jax.random.randint(k2, (64,), 0, 333))
    st = torch.from_numpy(src).requires_grad_(True)
    got = tmesh.chamfer_from_samples(st.reshape(-1, 3)[si],
                                     torch.from_numpy(tar)[ti])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jg = np.asarray(jg)
    _close(st.grad.numpy(), jg, 1e-5 * np.abs(jg).max())


def test_chamfer_loss_draws_each_cloud_from_its_own_length():
    src = torch.zeros(10, 3)
    tar = torch.ones(1000, 3) * torch.arange(1000.0)[:, None]
    gen = torch.Generator().manual_seed(0)
    si, ti = tmesh.chamfer_sample_indices(10, 1000, 500, gen)
    assert int(si.max()) < 10 and int(ti.max()) >= 10
    gen = torch.Generator().manual_seed(0)
    a = tmesh.chamfer_loss(src, tar, gen, samples=500)
    b = tmesh.chamfer_from_samples(src[si], tar[ti])
    assert torch.equal(a, b)
