"""The port's capture tools against the JAX package's, on the CPU.

* RGBD streams: a stream written by either package is byte-equal to the
  other's (the port's JPEG encoder writes OpenCV's bytes) and reads back
  in both: depth and index maps exactly, colours exactly (the port's
  decoder gives OpenCV's pixels).
* Camera rigs: 1e-12 absolute (float64 numpy in both; the rig rotation
  by the port's Rodrigues, OpenCV's in JAX).
* Correspondence: the same permutation; reconstruction and camera frusta:
  equal arrays and byte-equal files; the jet colours equal OpenCV's.
"""

import numpy as np
import pytest
import torch

from bodyfitting_tpu.io import rgbd_stream as jrs
from bodyfitting_tpu.utils import cam_pose_vis as jcv
from bodyfitting_tpu.utils import camera_rig as jcr
from bodyfitting_tpu.utils import correspondence as jcorr
from bodyfitting_tpu.utils import reconstruction as jrec
from bodyfitting_torch.io import rgbd_stream as trs
from bodyfitting_torch.utils import cam_pose_vis as tcv
from bodyfitting_torch.utils import camera_rig as tcr
from bodyfitting_torch.utils import correspondence as tcorr
from bodyfitting_torch.utils import reconstruction as trec


def _frames(n=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:45, 0:61]
    colors = [np.stack([(x * 4 + 7 * i) % 256, (y * 5) % 256,
                        rng.integers(0, 256, (45, 61))], -1).astype(np.uint8)
              for i in range(n)]
    depths = [rng.uniform(500, 3000, size=(23, 31)).astype(np.uint16)
              for _ in range(n)]
    indices = [rng.integers(0, 3, size=(23, 31)).astype(np.uint8)
               for _ in range(n)]
    return colors, depths, indices


def _intrinsics(mod):
    return mod.StreamIntrinsics(
        matrix=np.array([[400.0, 0, 30], [0, 401.0, 22], [0, 0, 1]],
                        np.float32),
        coeffs=np.arange(10, dtype=np.float32) * 0.01)


def test_rgbd_streams_are_byte_equal_and_cross_read(tmp_path):
    colors, depths, indices = _frames()
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.02, 0.0, -0.01]
    paths = {}
    for name, mod in (("jax", jrs), ("port", trs)):
        paths[name] = str(tmp_path / f"{name}.stream")
        mod.write_rgbd_stream(paths[name], colors, depths, indices,
                              color_intrinsics=_intrinsics(mod),
                              depth2color=ext, timestamps=[5, 6, 9])
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    for reader in (jrs, trs):
        for path in paths.values():
            dec = reader.RGBDStreamDecoder(path)
            assert dec.frame_count == 3
            assert (dec.color_width, dec.color_height) == (61, 45)
            np.testing.assert_array_equal(dec.depth2color, ext)
            np.testing.assert_array_equal(dec.color_intrinsics.coeffs,
                                          _intrinsics(trs).coeffs)
            assert dec.get_frame(3) is None
            dec.close()
    jd, td = jrs.RGBDStreamDecoder(paths["port"]), trs.RGBDStreamDecoder(
        paths["jax"])
    for i in range(3):
        a, b = jd.get_frame(i), td.get_frame(i)
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(b.depth16, depths[i])
        np.testing.assert_array_equal(b.index, indices[i])
        np.testing.assert_array_equal(a.depth_raw, b.depth_raw)
        assert (a.color_timestamp, a.depth_timestamp) == (
            b.color_timestamp, b.depth_timestamp)
    jd.close()
    td.close()
    for flags in ((True, False, False), (True, True, True)):
        a = jrs.read_rgbd(paths["port"], *flags)
        b = trs.read_rgbd(paths["jax"], *flags)
        for la, lb in zip(a, b):
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x, y)


def test_rgbd_stream_drops_a_truncated_frame(tmp_path):
    colors, depths, indices = _frames(2, seed=1)
    path = str(tmp_path / "cut.stream")
    trs.write_rgbd_stream(path, colors, depths, indices)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-10])
    for mod in (jrs, trs):
        dec = mod.RGBDStreamDecoder(path)
        assert dec.frame_count == 1
        dec.close()


def test_grey_colour_frames_round_trip(tmp_path):
    colors, depths, indices = _frames(1, seed=2)
    grey = [colors[0][..., 0].copy()]
    paths = [str(tmp_path / "j.stream"), str(tmp_path / "t.stream")]
    jrs.write_rgbd_stream(paths[0], grey, depths, indices)
    trs.write_rgbd_stream(paths[1], grey, depths, indices)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    a = jrs.RGBDStreamDecoder(paths[0]).get_frame(0).color
    b = trs.RGBDStreamDecoder(paths[1]).get_frame(0).color
    np.testing.assert_array_equal(a, b)


def _camera(mod):
    return mod.DistortionCamera.from_flat(
        [500.0, 505.0, 320.0, 240.0, 0.05, -0.02, 0.001, 0.002, 0.01,
         640, 480])


def test_camera_rig_matches_jax():
    rng = np.random.default_rng(3)
    jc, tc = _camera(jcr), _camera(tcr)
    pts = rng.uniform(-0.4, 0.4, size=(50, 2))
    for f in ("distort", "undistort"):
        np.testing.assert_allclose(getattr(tc, f)(pts), getattr(jc, f)(pts),
                                   rtol=0, atol=1e-12)
    uv = rng.uniform(100, 500, size=(30, 2))
    depth = rng.uniform(0.5, 3.0, size=30)
    p3 = tc.reproject(uv, depth)
    np.testing.assert_allclose(p3, jc.reproject(uv, depth), atol=1e-12)
    np.testing.assert_allclose(tc.project(p3), jc.project(p3), atol=1e-9)
    for o in range(4):
        a, b = tc.rotate(o), jc.rotate(o)
        np.testing.assert_array_equal(a.K, b.K)
        np.testing.assert_array_equal(a.dist, b.dist)
        assert (a.width, a.height) == (b.width, b.height)
    np.testing.assert_array_equal(tc.resize(0.5).K, jc.resize(0.5).K)
    rvec, tvec = np.array([0.05, -0.1, 0.02]), np.array([0.03, 0.0, 0.01])
    trig = tcr.DualCamera(rgb=tc, tof=tc.resize(0.5), rvec=rvec, tvec=tvec)
    jrig = jcr.DualCamera(rgb=jc, tof=jc.resize(0.5), rvec=rvec, tvec=tvec)
    s = np.concatenate([rng.uniform(50, 250, size=(20, 2)),
                        rng.uniform(1.0, 2.0, size=(20, 1))], axis=1)
    np.testing.assert_allclose(trig.tof2rgb(s), jrig.tof2rgb(s), rtol=0,
                               atol=1e-9)
    K = tc.K
    np.testing.assert_allclose(tcr.reproject3d(uv, depth, K, tc.dist),
                               jcr.reproject3d(uv, depth, K, jc.dist),
                               atol=1e-12)


def test_correspondence_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(40, 3))
    perm = rng.permutation(40)
    noisy = verts[perm] + rng.normal(scale=1e-4, size=(40, 3))
    got = tcorr.match_vertices(verts, noisy)
    np.testing.assert_array_equal(got, jcorr.match_vertices(verts, noisy))
    faces = rng.integers(0, 40, size=(10, 3))
    for a, b in zip(tcorr.reorder_mesh(verts, faces, got),
                    jcorr.reorder_mesh(verts, faces, got)):
        np.testing.assert_array_equal(a, b)


def test_reconstruction_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(trec.JET_LUT_BGR, lut)
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 4.0, size=(24, 32))
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    for md in (None, 3.0):
        np.testing.assert_array_equal(trec.depth_colorize(depth, md),
                                      jrec.depth_colorize(depth, md))
    np.testing.assert_array_equal(trec.depth_colorize(np.zeros((3, 4))),
                                  jrec.depth_colorize(np.zeros((3, 4))))
    K = np.array([[100.0, 0, 16], [0, 101.0, 12], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = [1, 2, 3]
    color = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    for kw in (dict(), dict(c2w=c2w, color=color, stride=2),
               dict(depth_scale=1e-3, max_depth=3e-3)):
        a = trec.pointcloud_from_depthmap(depth, K, **kw)
        b = jrec.pointcloud_from_depthmap(depth, K, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            np.testing.assert_array_equal(a[1], b[1])
    pts, cols = trec.pointcloud_from_depthmap(depth, K, color=color)
    for c in (None, cols):
        trec.save_pointcloud_obj(str(tmp_path / "t.obj"), pts, c)
        jrec.save_pointcloud_obj(str(tmp_path / "j.obj"), pts, c)
        assert open(tmp_path / "t.obj").read() == open(tmp_path / "j.obj").read()
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(trec.copy2cpu(x), x.numpy())
    np.testing.assert_array_equal(trec.copy2cpu(np.ones(3)), np.ones(3))


def test_cam_pose_vis_matches_jax(tmp_path):
    from bodyfitting_torch.ops.camera import ring_cameras

    w2cs = ring_cameras(6, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64),
                        2.5).numpy()
    c2ws = np.linalg.inv(w2cs)
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    np.testing.assert_array_equal(tcv.frustum_vertices(c2ws[1], K),
                                  jcv.frustum_vertices(c2ws[1], K))
    for Ks in (K, np.stack([K] * 6)):
        tcv.cam_pose_vis(str(tmp_path / "t.obj"), c2ws, Ks)
        jcv.cam_pose_vis(str(tmp_path / "j.obj"), c2ws, Ks)
        assert open(tmp_path / "t.obj").read() == open(tmp_path / "j.obj").read()
