"""The port's texture stage against the JAX package's, on the CPU.

* Camera schedules, ``default_K`` and ``scene_bounds``: exactly equal
  (the same numpy code).
* ``render_scan_views``: masks exactly equal, images within 1 level of
  255 (uint8 truncation of values that differ by rounding).
* ``fit_texture``, both routes (cached maps and re-raster), on the JAX
  tests' quad (S=16, 32² renders, 40 iterations) and on a small sphere
  mesh with ``per_face_atlas`` UVs.  Loss traces to 1e-5 relative and
  textures to 1e-4: the JAX CPU route normalises the barycentric weights
  where the port multiplies by the depth (~1e-7 apart in the UVs) and
  XLA:CPU contracts multiply-adds, so renders differ in the last bits and
  Adam's normalised steps carry that into the texture.  The quad is
  scaled to 0.9 in y: on the square quad its diagonal passes through
  pixel centres, where XLA's fused multiply-adds leave cracks that the
  port does not (6 pixels of a view).
* ``per_face_atlas`` exactly; ``fill_texture_holes`` (scipy) exactly equal
  to the JAX one (OpenCV); ``inpaint_unseen`` and
  ``displacement_map_to8b`` exactly; the atlas coverage exactly and
  ``bake_displacement_map`` to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.fitting import texture as jtf
from bodyfitting_tpu.models.body_model import sphere_mesh
from bodyfitting_tpu.utils import uv_unwrap as juv
from bodyfitting_torch.fitting import texture as ttf
from bodyfitting_torch.utils import uv_unwrap as tuv
from tests.test_texture import _unit_quad


def _quad(scale=1.0):
    verts, faces, face_uvs = _unit_quad(scale=scale)
    return verts * np.array([1.0, 0.9, 1.0], np.float32), faces, face_uvs


def _sphere():
    rng = np.random.default_rng(0)
    v, f = sphere_mesh(60, rng)
    uvs, fu = juv.per_face_atlas(len(f))
    tex = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    return v.astype(np.float32), f.astype(np.int32), uvs[fu], tex


def test_camera_schedules_equal():
    center = np.array([0.1, 0.9, -0.2])
    cfg = jtf.TextureFitConfig()
    np.testing.assert_array_equal(
        ttf.training_pose_schedule(ttf.TextureFitConfig(), center, 2.2),
        jtf.training_pose_schedule(cfg, center, 2.2))
    np.testing.assert_array_equal(ttf.ring_poses(center, 7, 1.5),
                                  jtf.ring_poses(center, 7, 1.5))
    np.testing.assert_array_equal(ttf.sphere_pose(2.0, 0.3, 1.2, center),
                                  jtf.sphere_pose(2.0, 0.3, 1.2, center))
    up = np.array([0.0, 3.0, 0.0])
    np.testing.assert_array_equal(ttf.look_at_w2c(up, np.zeros(3)),
                                  jtf.look_at_w2c(up, np.zeros(3)))
    np.testing.assert_array_equal(ttf.default_K(48), jtf.default_K(48))
    v = np.random.default_rng(1).normal(size=(30, 3))
    for a, b in zip(ttf.scene_bounds(v), jtf.scene_bounds(v)):
        np.testing.assert_array_equal(a, b)
    # the default schedule: 200 poses, 128 of them distinct
    assert dataclass_fields(ttf.TextureFitConfig) == dataclass_fields(
        jtf.TextureFitConfig)
    sched = ttf.training_pose_schedule(ttf.TextureFitConfig(), center, 2.2)
    assert len(np.unique(sched.reshape(200, -1), axis=0)) == 128


def dataclass_fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("mesh", ["quad", "sphere"])
def test_render_scan_views_matches_jax(mesh):
    if mesh == "quad":
        v, f, fu = _quad(0.5)
        tex = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(
            np.float32)
    else:
        v, f, fu, tex = _sphere()
    for white in (False, True):
        ij, mj, wj, kj = jtf.render_scan_views(v, f, fu, tex, imgsize=40,
                                               viewnum=4, face_block=4,
                                               white_bkgd=white)
        it, mt, wt, kt = ttf.render_scan_views(v, f, fu, tex, imgsize=40,
                                               viewnum=4, face_block=4,
                                               white_bkgd=white,
                                               device="cpu")
        assert it.dtype == np.uint8 and it.shape == (4, 40, 40, 3)
        np.testing.assert_array_equal(mt, mj)
        assert (mt > 0).sum() > 400
        assert np.abs(it.astype(int) - ij.astype(int)).max() <= 1
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(kt, kj)


def _fit_problem(mesh):
    if mesh == "quad":
        v, f, fu = _quad()
        S = 16
        target = np.zeros((S, S, 3), np.float32)
        target[: S // 2] = [0.9, 0.1, 0.1]
        target[S // 2:] = [0.1, 0.1, 0.9]
        base = dict(tex_img_size=S, render_img_size=32, iter_num=40, lr=5e-2,
                    round_views=4, round_view_iters=5, face_block=4)
        return (v, f, fu, v, f, fu, target), base
    v, f, fu, tex = _sphere()
    base = dict(tex_img_size=32, render_img_size=48, iter_num=30, lr=5e-2,
                round_views=6, round_view_iters=2, face_block=16)
    return (v, f, fu, v, f, fu, tex), base


@pytest.mark.parametrize("precompute", [True, False])
@pytest.mark.parametrize("mesh", ["quad", "sphere"])
def test_fit_texture_matches_jax(mesh, precompute):
    args, base = _fit_problem(mesh)
    tj, lj = jtf.fit_texture(*args, jtf.TextureFitConfig(
        precompute=precompute, **base))
    tt, lt = ttf.fit_texture(*args, ttf.TextureFitConfig(
        precompute=precompute, **base), device="cpu")
    lj = np.asarray(lj)
    assert lt.shape == lj.shape == (base["iter_num"],)
    assert tt.shape == (base["tex_img_size"],) * 2 + (3,)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5,
                               atol=1e-5 * np.abs(lj).max())
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert float(lt[-4:].sum()) < float(lt[:4].sum())
    assert float(tt.min()) >= 0.0 and float(tt.max()) <= 1.0


def test_fit_texture_tiling_knobs_change_nothing():
    """The JAX package's one-hot and program-shape knobs have no
    counterpart: any setting gives the gather route's result."""
    args, base = _fit_problem("quad")
    base["iter_num"] = 12
    ref = ttf.fit_texture(*args, ttf.TextureFitConfig(**base), device="cpu")
    got = ttf.fit_texture(*args, ttf.TextureFitConfig(
        bucketed_uv=False, uv_chunk=64, uv_window_rows=4, map_chunk=3,
        packed_glue=True, **base), device="cpu")
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])


def test_per_face_atlas_matches_jax():
    for n in (1, 7, 13688):
        for a, b in zip(tuv.per_face_atlas(n), juv.per_face_atlas(n)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(tuv.per_face_atlas(50, 0.2), juv.per_face_atlas(50, 0.2)):
        np.testing.assert_array_equal(a, b)
    faces = np.zeros((9, 3), np.int32)
    for a, b in zip(tuv.make_uv_template(None, faces),
                    juv.make_uv_template(None, faces)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tuv.per_face_atlas(0)


def test_make_uv_template_writes_the_jax_template(tmp_path):
    """The OBJ template (``vt`` / ``f v/vt`` lines and its MTL) is written
    byte for byte as the JAX writer does, and reads back as the atlas."""
    from bodyfitting_torch.io.obj import load_obj

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(12, 3)).astype(np.float32)
    faces = rng.integers(0, 12, size=(9, 3)).astype(np.int32)
    for pkg, tag in ((tuv, "port"), (juv, "jax")):
        uvs, fu = pkg.make_uv_template(verts, faces,
                                       str(tmp_path / f"{tag}.obj"))
    for ext in (".obj", ".mtl"):
        port = open(tmp_path / f"port{ext}").read()
        jax_ = open(tmp_path / f"jax{ext}").read()
        assert port == jax_.replace("jax.mtl", "port.mtl")
    back = load_obj(str(tmp_path / "port.obj"))
    np.testing.assert_array_equal(back.face_uvs, fu)
    np.testing.assert_array_equal(back.faces, faces)
    np.testing.assert_allclose(back.uvs, uvs, rtol=0, atol=5e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_texture_holes_matches_opencv(seed):
    rng = np.random.default_rng(seed)
    H, W = 40 + seed, 33
    tex = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cov = (rng.uniform(size=(H, W)) > 0.45).astype(np.float32)
    cov[:5] = 1.0
    cov[-4:, :] = 0.0
    for it in (1, 2):
        got = ttf.fill_texture_holes(tex, cov, iterations=it)
        want = jtf.fill_texture_holes(tex, cov, iterations=it)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_inpaint_unseen_matches_jax():
    rng = np.random.default_rng(4)
    tex = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    m = rng.uniform(size=(24, 20)) > 0.7
    got = ttf.inpaint_unseen(tex, m, iterations=30, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  jtf.inpaint_unseen(tex, m, iterations=30))
    np.testing.assert_array_equal(
        ttf.inpaint_unseen(tex, np.zeros_like(m), device="cpu"), tex)


def test_atlas_coverage_and_displacement_bake_match_jax():
    v, f, fu, _ = _sphere()
    S = 48
    rng = np.random.default_rng(5)
    disp = rng.normal(scale=0.01, size=(len(v), 3)).astype(np.float32)
    jcov = np.asarray(jtf.atlas_coverage_mask(jnp.asarray(fu), S,
                                              face_block=16))
    tcov = ttf.atlas_coverage_mask(fu, S, face_block=16, device="cpu")
    np.testing.assert_array_equal(tcov.numpy(), jcov)
    assert 0.2 < jcov.mean() < 0.8
    jm, jc = jtf.bake_displacement_map(jnp.asarray(fu), jnp.asarray(f),
                                       jnp.asarray(disp), S)
    raster = ttf.rasterize_uv_atlas(fu, S, device="cpu")
    tm, tc = ttf.bake_displacement_map(fu, f, disp, S, raster=raster,
                                       device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5 * 0.05)
    np.testing.assert_array_equal(
        ttf.displacement_map_to8b(tm.numpy(), tc.numpy()),
        jtf.displacement_map_to8b(tm.numpy(), tc.numpy()))
    np.testing.assert_array_equal(
        ttf.displacement_map_to8b(tm, tc),
        jtf.displacement_map_to8b(tm.numpy(), tc.numpy()))
    empty = np.zeros((S, S))
    np.testing.assert_array_equal(
        ttf.displacement_map_to8b(tm.numpy(), empty),
        jtf.displacement_map_to8b(tm.numpy(), empty))
