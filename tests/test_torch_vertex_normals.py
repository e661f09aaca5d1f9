"""Vertex normals, the smoothness term and the soft silhouette's backward
sum in a fixed order (``bodyfitting_torch/ops/gather.py``), and equal
the JAX functions.

f64 on the CPU; the ``gpu`` case holds two calls on the card bitwise
equal (``python -m pytest --noconftest -m gpu
tests/test_torch_vertex_normals.py`` there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.losses import mesh as jmesh
from bodyfitting_tpu.models.body_model import sphere_mesh as j_sphere_mesh
from bodyfitting_torch.losses import mesh as tmesh
from bodyfitting_torch.ops import gather as og


def _mesh(n=400, seed=0):
    """A seeded sphere mesh, jittered, with a degenerate face added."""
    verts, faces = j_sphere_mesh(n, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    verts = verts + rng.normal(scale=0.02, size=verts.shape)
    faces = np.concatenate([faces, faces[:1, [0, 0, 1]]]).astype(np.int64)
    return verts.astype(np.float64), faces


def test_row_index_orders_each_rows_positions():
    idx = torch.tensor([3, 0, 3, 1, 3, 0])
    ri = og.row_index(idx, 5)
    assert ri.order.tolist() == [1, 5, 3, 0, 2, 4]
    assert ri.counts.tolist() == [2, 1, 0, 3, 0]
    src = torch.arange(6, dtype=torch.float64)[:, None] * torch.tensor(
        [1.0, 10.0], dtype=torch.float64)
    want = torch.zeros(5, 2, dtype=torch.float64).index_add(0, idx, src)
    assert torch.equal(og.scatter_rows(src, ri), want)
    assert torch.equal(og.gather_rows(want, ri), want[idx])


def test_gather_and_scatter_gradients_are_each_others():
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(rng.integers(0, 7, size=40))
    ri = og.row_index(idx, 9)
    t = torch.tensor(rng.normal(size=(9, 3)), requires_grad=True)
    s = torch.tensor(rng.normal(size=(40, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: og.gather_rows(x, ri), (t,))
    assert torch.autograd.gradcheck(lambda x: og.scatter_rows(x, ri), (s,))


def test_cached_row_index_follows_the_tensor():
    faces = torch.tensor([[0, 1, 2], [2, 1, 3]])
    a = og.cached_row_index(faces, 4)
    assert og.cached_row_index(faces, 4) is a
    assert og.cached_row_index(faces.clone(), 4) is not a


def test_vertex_normals_and_gradient_equal_jax_f64():
    verts, faces = _mesh()
    w = np.random.default_rng(5).normal(size=verts.shape)
    v = torch.tensor(verts, requires_grad=True)
    vn = tmesh.compute_vertex_normals(v, torch.tensor(faces))
    (g,) = torch.autograd.grad((vn * torch.tensor(w)).sum(), [v])
    with jax.enable_x64(True):
        jf = jnp.asarray(faces)

        def both(x):
            return (jmesh.compute_vertex_normals(x, jf),
                    jax.grad(lambda y: jnp.sum(
                        jmesh.compute_vertex_normals(y, jf) * w))(x))

        jvn, jg = (np.asarray(a) for a in jax.jit(both)(jnp.asarray(verts)))
    assert jvn.dtype == np.float64
    np.testing.assert_allclose(vn.detach().numpy(), jvn, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(jg).max()))


def test_smoothness_and_gradient_equal_jax_f64():
    verts, faces = _mesh(300, seed=3)
    v = torch.tensor(verts, requires_grad=True)
    tf = torch.tensor(faces)
    sm = tmesh.normal_laplacian_smoothness(
        tmesh.compute_vertex_normals(v, tf), tf)
    (g,) = torch.autograd.grad(sm, [v])
    with jax.enable_x64(True):
        jf = jnp.asarray(faces)

        def jsm(x):
            return jmesh.normal_laplacian_smoothness(
                jmesh.compute_vertex_normals(x, jf), jf)

        jval, jg = jax.jit(jax.value_and_grad(jsm))(jnp.asarray(verts))
        jval, jg = float(jval), np.asarray(jg)
    np.testing.assert_allclose(float(sm), jval, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(jg).max()))


@pytest.mark.gpu
def test_vertex_normals_bitwise_repeatable_on_the_card():
    """Two calls of the normals, the smoothness term and their gradient on
    the card give the same bits (PyTorch's ``index_add`` did not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    verts, faces = _mesh(6890, seed=4)
    tf = torch.tensor(faces, device="cuda")
    w = torch.tensor(np.random.default_rng(6).normal(size=verts.shape),
                     dtype=torch.float32, device="cuda")
    outs = []
    for _ in range(2):
        v = torch.tensor(verts, dtype=torch.float32, device="cuda",
                         requires_grad=True)
        vn = tmesh.compute_vertex_normals(v, tf)
        loss = (vn * w).sum() + tmesh.normal_laplacian_smoothness(vn, tf)
        (g,) = torch.autograd.grad(loss, [v])
        outs.append((vn.detach().cpu(), g.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
