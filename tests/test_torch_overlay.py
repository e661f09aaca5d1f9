"""The port's debug overlays against the JAX package's, on the CPU.

The uint8 overlays are equal except where the two packages' float32
shading rounds to neighbouring levels: at most 1 level, at no more than
1 % of the pixels (the face assignment is the same: the z-buffer's face
indices equal JAX's on these meshes, kept off pixel centres' edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.utils import overlay as jov
from bodyfitting_torch.utils import overlay as tov


def _mesh(seed=0):
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    p = rng.normal(size=(120, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p *= [0.3, 0.8, 0.2]
    return p.astype(np.float32), ConvexHull(p).simplices.astype(np.int32)


def _camera(theta, H, W):
    c, s = np.cos(theta), np.sin(theta)
    c2w = np.eye(4)
    c2w[:3, :3] = [[c, 0, -s], [0, -1, 0], [s, 0, c]]
    c2w[:3, :3] = c2w[:3, :3] @ np.diag([1.0, 1.0, 1.0])
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0.0, 0.0, -2.5])
    K = np.array([[0.9 * W, 0, W / 2 + 0.3], [0, 0.9 * W, H / 2 - 0.2],
                  [0, 0, 1]])
    return c2w, K


def _assert_close_u8(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.01, (d > 0).mean()


@pytest.mark.parametrize("H,W", [(48, 64), (64, 40), (56, 56)])
def test_overlay_matches_jax(H, W):
    v, f = _mesh()
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    c2w, K = _camera(0.4, H, W)
    w2c = np.linalg.inv(c2w)
    got = tov.render_mesh_overlay(image, v, f, w2c, K, device="cpu")
    want = jov.render_mesh_overlay(image, v, f, w2c, K)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    _assert_close_u8(got, want)
    # the mesh covers part of the image; the rest is the image itself
    fg = (got != image).any(-1)
    assert 0.05 < fg.mean() < 0.9
    np.testing.assert_array_equal(got[~fg], image[~fg])


def test_fit_overlays_cadence_and_images_match_jax():
    v, f = _mesh(2)
    rng = np.random.default_rng(3)
    H, W = 40, 48
    images = [rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
              for _ in range(25)]
    cams = [_camera(0.25 * i, H, W) for i in range(25)]
    c2ws, Ks = [c for c, _ in cams], [k for _, k in cams]
    got = tov.render_fit_overlays(images, {"vertices": torch.from_numpy(v)},
                                  f, c2ws, Ks, skip=12, device="cpu")
    want = jov.render_fit_overlays(images, {"vertices": jnp.asarray(v)}, f,
                                   c2ws, Ks, skip=12)
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 12, 24]
    for (_, a), (_, b) in zip(got, want):
        _assert_close_u8(a, b)


def test_overlay_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f = _mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tov.render_mesh_overlay(np.zeros((8, 8, 3), np.uint8), v, f,
                                np.eye(4), np.eye(3))
