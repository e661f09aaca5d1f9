"""The port's kernel contracts (plain PyTorch versions, which serve CPU
tensors) against the JAX package's Pallas kernels in interpret mode and
against its XLA formulations.

Tolerances:
  * vs the Pallas ``bilinear_cov_grads``: atol 5e-3, because that kernel
    rounds the image and the hinge weights to bf16 before its MXU dots
    (pallas_kernels.py:1256-1258) while the port computes in f32;
  * vs the XLA one-hot hinge form: 1e-5 (both f32, same taps), with
    kink points (integer coordinates) left out of derivative checks,
    where autodiff of the hinge picks other subgradients;
  * contour match: ``idx`` exactly equal, payloads equal, ``d2`` to
    1 ulp (XLA:CPU fuses the multiply-add, the port does not); on the
    edge cases, whose coordinates make every d2 exact, all four bitwise;
  * rows scatter: 1e-6, or 2 n eps sum|g| for runs of n entries (f32
    sums in another order); the plain version bitwise against an
    explicit float32 loop in ascending ``p``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import jax

from bodyfitting_tpu.losses import silhouette as jsil
from bodyfitting_tpu.ops import pallas_kernels as pk
from bodyfitting_torch.ops import kernels as K
from chip_smoke import match_edge_cases, scatter_edge_cases


def _points(rng, H, W, n):
    """Random points over and around an [H, W] grid, plus integer points,
    border points and far-out points."""
    pts = rng.uniform(-3.0, [W + 2.0, H + 2.0], size=(n, 2))
    special = [
        [0.0, 0.0], [W - 1.0, H - 1.0], [3.0, 4.0], [7.0, 2.5], [2.5, 7.0],
        [-0.5, 3.2], [W - 0.5, 3.2], [3.2, -0.5], [3.2, H - 0.5],
        [-1.0, 2.0], [float(W), 2.0], [1e9, 5.0], [-1e9, 5.0],
        [5.0, 1e9], [np.inf, 3.0], [-3e38, -3e38],
    ]
    return np.concatenate([pts, special]).astype(np.float32)


def _images(rng, H, W):
    mask = np.zeros((H, W), np.float32)
    mask[H // 4: 3 * H // 4, W // 3: 2 * W // 3] = 1.0
    return np.stack([mask, rng.random((H, W)).astype(np.float32)])


MODES = [(True, True), (True, False), (False, False)]


@pytest.mark.parametrize("with_grads,with_cov", MODES)
def test_bilinear_matches_pallas(rng, with_grads, with_cov):
    H, W = 40, 56
    imgs = _images(rng, H, W)
    xy = _points(rng, H, W, 300)              # N = 316, not a tile multiple
    got = K.bilinear_cov_grads(
        torch.from_numpy(imgs),
        torch.from_numpy(np.stack([xy, xy[::-1].copy()])),
        with_grads, with_cov,
    ).numpy()
    for b, pts in enumerate([xy, xy[::-1].copy()]):
        ref = np.asarray(pk.bilinear_cov_grads(
            jnp.asarray(imgs[b]), jnp.asarray(pts), interpret=True,
            with_grads=with_grads, with_cov=with_cov,
        ))
        np.testing.assert_allclose(got[b], ref, atol=5e-3, rtol=0)


def test_bilinear_matches_xla_hinge_form(rng):
    H = W = 48
    imgs = _images(rng, H, W)
    xy = _points(rng, H, W, 400)
    got = K.bilinear_cov_grads(torch.from_numpy(imgs),
                               torch.from_numpy(np.stack([xy, xy])),
                               True, True).numpy()
    finite = np.abs(xy).max(1) < 1e8
    # with imsize = W - 1 the XLA form's pixel-grid scale is exactly 1
    for b in range(2):
        def s_and_c(p, b=b):
            return jsil._bilinear_sample_onehot_cov(
                jnp.asarray(imgs[b]), p, float(W - 1))

        xj = jnp.asarray(xy[finite])
        s, c = s_and_c(xj)
        np.testing.assert_allclose(got[b, 0, finite], np.asarray(s),
                                   atol=1e-5)
        np.testing.assert_allclose(got[b, 1, finite], np.asarray(c),
                                   atol=1e-5)
        ds = np.asarray(jax.grad(lambda p: jnp.sum(s_and_c(p)[0]))(xj))
        dc = np.asarray(jax.grad(lambda p: jnp.sum(s_and_c(p)[1]))(xj))
        f = xy[finite]
        smooth = np.all(np.abs(f - np.round(f)) > 1e-3, axis=1)
        for row, ref in ((2, ds[:, 0]), (3, ds[:, 1]),
                         (4, dc[:, 0]), (5, dc[:, 1])):
            np.testing.assert_allclose(got[b, row, finite][smooth],
                                       ref[smooth], atol=1e-5)
    # far-out points read zero everywhere, as the hinge form gives
    np.testing.assert_array_equal(got[:, :, ~finite], 0.0)
    # an exact integer coordinate has derivative 0 (the sign() rule)
    at = np.flatnonzero((xy[:, 0] == 3.0) & (xy[:, 1] == 4.0))
    np.testing.assert_array_equal(got[:, 2:, at], 0.0)


def test_bilinear_crop_value_matches_xla_crop_branch(rng):
    """Crop mode against the XLA crop branch of the stay-inside term, on
    the f32 crop and on its bit mask (what the fits sample)."""
    Hc, Wc, H = 24, 40, 64
    crop = (rng.random((Hc, Wc)) > 0.5).astype(np.float32)
    origin = np.array([9.0, 13.0], np.float32)
    xy = rng.uniform(0, H, size=(257, 2)).astype(np.float32)
    old = jsil.STAY_INSIDE
    jsil.STAY_INSIDE = "xla"
    try:
        s_ref, _ = jsil._stay_inside_cov_crop(
            jnp.asarray(crop), jnp.asarray(origin), jnp.asarray(xy),
            float(H - 1), (H, H))
    finally:
        jsil.STAY_INSIDE = old
    f32 = torch.from_numpy(crop[None])
    for img in (f32, K.pack_bits(f32)):
        got = K.bilinear_cov_grads(img, torch.from_numpy((xy - origin)[None]),
                                   with_grads=False, with_cov=False)
        np.testing.assert_allclose(got[0, 0].numpy(), np.asarray(s_ref),
                                   atol=1e-5)


def _match_case(rng, P, M):
    proj = rng.uniform(0, 64, size=(M, 2)).astype(np.float32)
    proj[M // 2: M // 2 + 50] = proj[:50]          # duplicated candidates
    proj[-3:] = proj[5]                            # ties across m-blocks
    contour = rng.uniform(-5, 70, size=(P, 2)).astype(np.float32)
    contour[:40] = np.round(contour[:40])          # lattice ties
    lattice = np.round(proj[:20])
    proj[20:40] = lattice + [1.0, 0.0]
    proj[40:60] = lattice - [1.0, 0.0]
    contour[40:60] = lattice                       # equidistant pairs
    valid = (rng.random(M) > 0.3).astype(np.float32)
    inside = (rng.random(M) > 0.5).astype(np.float32)
    return contour, proj, valid, inside


@pytest.mark.parametrize("P,M", [(200, 300), (2000, 1500)])
def test_contour_match_matches_pallas(rng, P, M):
    contour, proj, valid, inside = _match_case(rng, P, M)
    all_invalid = np.zeros_like(valid)
    t = torch.from_numpy
    got = K.contour_match_full(
        t(np.stack([contour, contour])), t(np.stack([proj, proj])),
        t(np.stack([valid, all_invalid])), t(np.stack([inside, inside])),
    )
    for b, v in enumerate([valid, all_invalid]):
        ref = pk.contour_match_full(
            jnp.asarray(contour), jnp.asarray(proj), jnp.asarray(v),
            jnp.asarray(inside), interpret=True,
        )
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
        for g, r in zip((got[2], got[3]), (ref[2], ref[3])):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
        # d2 to 1 ulp: XLA:CPU contracts dx*dx + dy*dy into a fused
        # multiply-add, the port rounds each operation
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(ref[0]),
                                   rtol=3e-7)
    # an all-invalid row keeps the start value: idx 0, matched (0, 0)
    assert got[1][1].abs().sum() == 0 and got[2][1].abs().sum() == 0
    assert got[3][1].abs().sum() == 0


def test_contour_min_idx_matches_pallas(rng):
    contour, proj, valid, _ = _match_case(rng, 300, 1100)
    d2, idx = K.contour_min_idx(torch.from_numpy(contour[None]),
                                torch.from_numpy(proj[None]),
                                torch.from_numpy(valid[None]))
    rd2, ridx = pk.contour_min_idx(jnp.asarray(contour), jnp.asarray(proj),
                                   jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d2[0].numpy(), np.asarray(rd2), rtol=3e-7)


@pytest.mark.parametrize("P", [300, 512, 1500])
def test_rows_scatter_add_matches_pallas(rng, P):
    C, M = 2, 1100
    idx = rng.integers(0, M + 40, size=P).astype(np.int32)  # some >= M
    idx[:30] = 7                                            # repeats
    idx[30:40] = M - 1
    g = rng.normal(size=(P, C)).astype(np.float32)
    got = K.rows_scatter_add(torch.from_numpy(idx[None]),
                             torch.from_numpy(g[None]), M)
    ref = pk.rows_scatter_add(jnp.asarray(idx), jnp.asarray(g), M,
                              interpret=True)
    assert got.shape == (1, C, M)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-6)


def test_rows_scatter_add_drops_negative_idx():
    idx = torch.tensor([[0, -1, 2, 5]], dtype=torch.int32)
    g = torch.ones(1, 4, 2)
    out = K.rows_scatter_add(idx, g, 3)
    np.testing.assert_array_equal(out[0].numpy(),
                                  [[1.0, 0.0, 1.0], [1.0, 0.0, 1.0]])


def test_rows_scatter_add_takes_two_columns_only():
    """Its one caller scatters x/y cotangents; other widths raise."""
    idx = torch.zeros((1, 4), dtype=torch.int32)
    for C in (1, 3):
        with pytest.raises(ValueError, match="BV, P, 2"):
            K.rows_scatter_add(idx, torch.ones(1, 4, C), 3)


@pytest.mark.parametrize("case", list(match_edge_cases()))
def test_contour_match_edge_cases_match_pallas(case):
    """Ties at the lane stride and across chunks, also among invalid
    candidates; a row whose only valid candidate is the last; M = 1 and
    P = 1: all four outputs bitwise."""
    contour, proj, valid, inside = match_edge_cases()[case]
    t = torch.from_numpy
    got = K.contour_match_full(t(contour[None]), t(proj[None]),
                               t(valid[None]), t(inside[None]))
    ref = pk.contour_match_full(jnp.asarray(contour), jnp.asarray(proj),
                                jnp.asarray(valid), jnp.asarray(inside),
                                interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    d2, idx = K.contour_min_idx(t(contour[None]), t(proj[None]),
                                t(valid[None]))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(d2[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("contour", [
    [[1, 2], [5, 5], [4, 4], [0, 0], [3, 6]],
    [[2, 2], [9, 9], [3, 3], [1, 1], [6, 1], [5, 6]],
])
def test_contour_match_nan_candidate_matches_xla_route(monkeypatch,
                                                       contour):
    """A row with an invalid NaN candidate (a vertex at camera z = 0,
    which projects to 0/0): the port's plain match against the JAX XLA
    route of ``silhouette_loss`` (``CONTOUR_MATCH = "xla"``), whose
    argmin input and output are recorded.  ``idx`` and ``d2`` agree
    exactly (integer coordinates: every d2 is exact).  The route's
    one-hot matmul makes every matched coordinate NaN (0 x NaN), so
    ``matched`` and ``in_match`` are held to a gather at its ``idx``, which
    is what the one-hot stands for.  Unlike the Pallas kernel, neither
    loses the row's other candidates (ROADMAP.md §3)."""
    monkeypatch.setattr(jsil, "CONTOUR_MATCH", "xla")
    seen = []
    argmin = jnp.argmin

    def recorded(x, axis=None, **kw):
        out = argmin(x, axis=axis, **kw)
        jax.debug.callback(
            lambda d2, i: seen.append((np.asarray(d2), np.asarray(i))), x, out)
        return out

    monkeypatch.setattr(jnp, "argmin", recorded)
    # identity cameras at the origin: proj = (x / z, y / z), exactly
    verts = np.array([[1, 2, 1], [0, 0, 0], [5, 5, 1], [3, 7, 1]],
                     np.float32)
    contour = np.asarray(contour, np.float32)
    loss = jsil.silhouette_loss(
        jnp.asarray(contour[None]), jnp.ones((1, len(contour))),
        jnp.ones((1, 16, 16)), jnp.eye(4)[None], jnp.eye(3)[None],
        jnp.asarray(verts), vertex_stride=1, imsize=16.0)
    jax.effects_barrier()
    monkeypatch.undo()
    assert np.isnan(float(loss))         # the route's 0 x NaN, as stated
    ((d2_xla, idx_xla),) = seen
    with np.errstate(invalid="ignore"):
        proj = verts[:, :2] / verts[:, 2:]
    inside = ((proj >= 0) & (proj < 16)).all(-1).astype(np.float32)
    assert inside.tolist() == [1, 0, 1, 1]
    t = torch.from_numpy
    d2, idx, matched, in_match = K.contour_match_full_plain(
        t(contour[None]), t(proj[None]), t(inside[None]), t(inside[None]))
    np.testing.assert_array_equal(idx[0].numpy(), idx_xla)
    np.testing.assert_array_equal(
        d2[0].numpy(), d2_xla[np.arange(len(contour)), idx_xla])
    np.testing.assert_array_equal(matched[0].numpy(), proj[idx_xla])
    np.testing.assert_array_equal(in_match[0].numpy(), inside[idx_xla])


def _ascending_loop(idx, g, M):
    """The contract written out: float32 sums from 0, ascending ``p``."""
    out = np.zeros(idx.shape[:1] + (g.shape[-1], M), np.float32)
    for b in range(idx.shape[0]):
        for p in range(idx.shape[1]):
            m = idx[b, p]
            if 0 <= m < M:
                out[b, :, m] += g[b, p]
    return out


def test_rows_scatter_add_plain_sums_in_ascending_p(rng):
    BV, P, M = 8, 3001, 500
    idx = rng.integers(-20, M + 20, size=(BV, P)).astype(np.int32)
    idx[:, 100:400] = 3                            # long runs
    idx[2] = 9
    g = (rng.normal(size=(BV, P, 2)) * 10.0 ** rng.integers(
        -3, 4, size=(BV, P, 1))).astype(np.float32)
    got = K.rows_scatter_add_plain(torch.from_numpy(idx),
                                   torch.from_numpy(g), M)
    np.testing.assert_array_equal(got.numpy(), _ascending_loop(idx, g, M))


@pytest.mark.parametrize("case", list(scatter_edge_cases()))
def test_rows_scatter_add_edge_cases(case):
    """Bitwise the ascending loop; against the Pallas kernel within the
    bound of two summation orders of a run's n entries."""
    idx, g, M = scatter_edge_cases()[case]
    got = K.rows_scatter_add(torch.from_numpy(idx[None]),
                             torch.from_numpy(g[None]), M)[0].numpy()
    np.testing.assert_array_equal(got, _ascending_loop(idx[None], g[None],
                                                       M)[0])
    ref = np.asarray(pk.rows_scatter_add(jnp.asarray(idx), jnp.asarray(g),
                                         M, interpret=True))
    n = _ascending_loop(idx[None], np.ones_like(g)[None], M)[0]
    bound = 2 * n * 2.0 ** -23 * _ascending_loop(idx[None], np.abs(g)[None],
                                                 M)[0]
    assert (np.abs(got - ref) <= bound).all()
