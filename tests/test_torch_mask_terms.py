"""The fused per-view mask term (``FUSED_MASK_TERM = "fused"``) and
``silhouette_loss(terms=...)`` against the JAX package, on the CPU.

Tolerances:
  * against JAX's fused op (``_mask_view_terms_fused``, Pallas kernels in
    interpret mode) and JAX's ``terms=`` choices: rtol 1e-6 on values,
    2e-6 of the largest gradient entry on gradients, JAX's own fused vs
    separate tolerances (``tests/test_silhouette_crop.py``).  The Pallas
    sampler rounds its hinge weights to bf16, so the vertices here
    project onto a 1/256 pixel grid (off the integers), where those
    weights are exact in bf16 and both packages sample exactly; the
    per-view sums still run in other orders;
  * the port's fused route against its separate route: the same
    tolerances (one f32 rounding per term, other summation orders);
  * staged f64 fits under both routes: 1e-7 relative on the loss trace
    and 1e-7 of each parameter block's scale;
  * on the card (``gpu``): both kernels bitwise their plain versions.

The JAX package is imported inside the tests that use it, so the card's
machine, which has no JAX, runs the ``gpu`` case:
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_mask_terms.py``.
"""

import numpy as np
import pytest
import torch

from bodyfitting_torch.fitting import smplify as tfit
from bodyfitting_torch.losses import silhouette as tsil
from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops.kernels import mask_terms

H = 128
IMSIZE = float(H - 1)        # (W - 1) / imsize = 1: xyhat = proj exactly
FOCAL = 64.0


def _masks():
    masks = np.zeros((2, H, H), np.float32)
    masks[0, 30:90, 40:80] = 1.0
    masks[1, 10:50, 20:100] = 1.0
    masks[1, 45:70, 60:75] = 1.0
    return masks


def _cameras(n):
    """Identity rotations 2 units from the origin, the second shifted a
    quarter unit in x: ``proj = 32 x + 64 (+ 8)`` exactly for points at
    world z = 0."""
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, 2, 3] = 2.0
    w2c[1::2, 0, 3] = 0.25
    Kc = np.array([[FOCAL, 0, H / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                  np.float32)
    return w2c, np.tile(Kc, (n, 1, 1))


def _grid_verts(rng, B=2, V=240):
    """World points at z = 0 whose projections fall on odd multiples of
    1/256 px, some of them outside the 128^2 image."""
    m = rng.integers(-3000, 3000, size=(B, V, 2)) * 2 + 1
    xy = m / 8192.0 * 3.0                   # 32 * xy = 3 m / 256
    return np.concatenate([xy, np.zeros((B, V, 1))], -1).astype(np.float32)


def _inputs(n_views=2):
    """Host inputs by the port's own preparation (equal to the JAX
    package's, ``tests/test_torch_losses.py``)."""
    masks = _masks()[:n_views]
    contours, valid = tsil.extract_contours(list(masks))
    rc, rw = tsil.resample_contours(contours, valid, 64)
    crops, origins, _ = tsil.compute_mask_crops(list(masks))
    w2cs, Ks = _cameras(n_views)
    return dict(rc=rc, rw=rw, crops=crops, origins=origins, masks=masks,
                w2cs=w2cs, Ks=Ks, vvalid=np.ones(n_views, np.float32))


def _jax_loss(inp, verts, terms=("icp", "binary"), crop=True,
              fused=True):
    """JAX's loss and vertex gradient for one frame, on the Pallas route
    (interpret mode); ``fused`` selects ``FUSED_MASK_TERM``."""
    import jax
    import jax.numpy as jnp

    from bodyfitting_tpu.losses import silhouette as jsil

    kw = dict(imsize=IMSIZE, vertex_stride=1, terms=terms)
    if crop:
        kw.update(mask_crops=jnp.asarray(inp["crops"]),
                  mask_crop_origins=jnp.asarray(inp["origins"]),
                  mask_view_valid=jnp.asarray(inp["vvalid"]),
                  full_hw=(H, H))
    old = jsil.STAY_INSIDE, jsil.CONTOUR_MATCH, jsil.FUSED_MASK_TERM
    jsil.STAY_INSIDE = jsil.CONTOUR_MATCH = "pallas"
    jsil.FUSED_MASK_TERM = "fused" if fused else "separate"
    try:
        return jax.value_and_grad(lambda v: jsil.silhouette_loss(
            jnp.asarray(inp["rc"]), jnp.asarray(inp["rw"]),
            None if crop else jnp.asarray(inp["masks"]),
            jnp.asarray(inp["w2cs"]), jnp.asarray(inp["Ks"]), v, **kw,
        ))(jnp.asarray(verts))
    finally:
        jsil.STAY_INSIDE, jsil.CONTOUR_MATCH, jsil.FUSED_MASK_TERM = old


def _torch_loss(inp, verts, route="fused", terms=("icp", "binary"),
                crop=True, bits=False, dtype=torch.float32):
    """The port's loss ``[B]`` and vertex gradient for frames ``verts``."""
    B = verts.shape[0]

    def t(a):
        return torch.from_numpy(
            np.broadcast_to(a, (B,) + a.shape).copy()).to(dtype)

    kw = dict(imsize=IMSIZE, vertex_stride=1, terms=terms)
    if crop:
        crops = t(inp["crops"])
        kw.update(mask_crops=tsil.mask_crops_bits(crops) if bits else crops,
                  mask_crop_origins=t(inp["origins"]),
                  mask_view_valid=t(inp["vvalid"]), full_hw=(H, H))
    v = torch.from_numpy(verts).to(dtype).requires_grad_(True)
    old = tsil.FUSED_MASK_TERM
    tsil.FUSED_MASK_TERM = route
    try:
        loss = tsil.silhouette_loss(
            t(inp["rc"]), t(inp["rw"]), None if crop else t(inp["masks"]),
            t(inp["w2cs"]), t(inp["Ks"]), v, **kw)
    finally:
        tsil.FUSED_MASK_TERM = old
    (g,) = torch.autograd.grad(loss.sum(), v)
    return loss.detach().numpy(), g.numpy()


def _close(got, ref):
    gl, gg = got
    rl, rg = ref
    np.testing.assert_allclose(gl, rl, rtol=1e-6)
    np.testing.assert_allclose(
        gg, rg, atol=2e-6 * max(1e-30, float(np.nanmax(np.abs(rg)))))


def _counted(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("bits", [False, True], ids=["f32 crops",
                                                      "bit-mask crops"])
def test_fused_route_matches_jax_fused_op(monkeypatch, rng, bits):
    """Both routes fused: the port's MaskViewTerms (its plain version on
    the CPU) against JAX's ``_mask_view_terms_fused``, each frame."""
    from bodyfitting_tpu.losses import silhouette as jsil

    inp = _inputs()
    verts = _grid_verts(rng)
    jax_calls = _counted(monkeypatch, jsil, "_mask_view_terms_fused")
    port_calls = _counted(monkeypatch, tsil, "mask_terms_forward")
    loss, grad = _torch_loss(inp, verts, bits=bits)
    assert port_calls == [1]
    for b in range(verts.shape[0]):
        jl, jg = _jax_loss(inp, verts[b])
        _close((loss[b], grad[b]), (float(jl), np.asarray(jg)))
    assert jax_calls          # traced through the fused op
    assert np.abs(grad).max() > 0


@pytest.mark.parametrize("crop", [True, False], ids=["crops", "full masks"])
@pytest.mark.parametrize("terms", [("icp", "binary"), ("icp",),
                                   ("binary",)], ids=["both", "icp",
                                                      "binary"])
def test_terms_match_jax(rng, terms, crop):
    """``terms=`` against JAX's, on the separate routes of both."""
    inp = _inputs()
    verts = _grid_verts(rng)
    loss, grad = _torch_loss(inp, verts, route="auto", terms=terms,
                             crop=crop)
    for b in range(verts.shape[0]):
        jl, jg = _jax_loss(inp, verts[b], terms=terms, crop=crop,
                           fused=False)
        _close((loss[b], grad[b]), (float(jl), np.asarray(jg)))


def test_terms_split_the_loss(rng):
    """The two single terms add up to both (the stay-inside term weighted
    by ``epsilon`` inside the loss), and only both take the fused route."""
    inp = _inputs()
    verts = _grid_verts(rng)
    both = _torch_loss(inp, verts, route="auto")[0]
    icp = _torch_loss(inp, verts, route="fused", terms=("icp",))[0]
    binary = _torch_loss(inp, verts, route="fused", terms=("binary",))[0]
    np.testing.assert_allclose(icp + binary, both, rtol=1e-6)
    assert (icp > 0).all() and (binary > 0).all()


def _nan_verts(verts):
    """One vertex at camera depth 0 on the optical axis (0/0: NaN), one
    off it (x/0: inf)."""
    v = verts.copy()
    v[:, 5] = [0.0, 0.0, -2.0]
    v[:, 9] = [0.3, 0.0, -2.0]
    return v


@pytest.mark.parametrize("case", ["random", "padded view", "NaN projection",
                                  "bit-mask crops"])
def test_fused_matches_separate(rng, case):
    """The port's two routes on the same frames: random vertices (not on
    a grid), a padded third view (``vvalid = 0``, all-ones crop, no
    contour) and a vertex at camera depth 0, which give what the separate
    route gives (NaN where it is NaN)."""
    inp = _inputs()
    verts = (rng.normal(size=(2, 300, 3)) * 0.4).astype(np.float32)
    if case == "padded view":
        for k, fill in (("rc", 0.0), ("rw", 0.0), ("crops", 1.0),
                        ("origins", 0.0), ("vvalid", 0.0)):
            a = inp[k]
            inp[k] = np.concatenate([a, np.full((1,) + a.shape[1:], fill,
                                                np.float32)])
        inp["w2cs"], inp["Ks"] = _cameras(3)
    if case == "NaN projection":
        verts = _nan_verts(verts)
    bits = case == "bit-mask crops"
    fused = _torch_loss(inp, verts, route="fused", bits=bits)
    separate = _torch_loss(inp, verts, route="separate", bits=bits)
    if case == "NaN projection":
        assert np.isnan(separate[0]).all() and np.isnan(fused[0]).all()
        np.testing.assert_array_equal(np.isnan(fused[1]),
                                      np.isnan(separate[1]))
        finite = ~np.isnan(separate[1])
        assert finite.any()
        np.testing.assert_allclose(
            fused[1][finite], separate[1][finite],
            atol=2e-6 * float(np.abs(separate[1][finite]).max()))
        return
    _close(fused, separate)
    if case == "padded view":
        # the padded view adds nothing: both frames equal two real views
        two = _torch_loss(_inputs(), verts, route="fused")
        _close(fused, two)


def test_plain_sums_in_the_kernels_order():
    """``tree_sum`` is the padded halving tree, written out."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 3, 5, 64, 100, 2619):
        x = rng.normal(size=(3, n)).astype(np.float32)
        ref = np.zeros(3, np.float32)
        if n:
            p = 1 << max(n - 1, 0).bit_length()
            a = np.concatenate([x, np.zeros((3, p - n), np.float32)], 1)
            while a.shape[1] > 1:
                h = a.shape[1] // 2
                a = a[:, :h] + a[:, h:]
            ref = a[:, 0]
        got = mask_terms.tree_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_wrappers_on_cpu_run_the_plain_versions(rng):
    """On CPU tensors both wrappers are their plain versions (no launch),
    the backward equals autograd's of the separate route at g = 1, and
    the autograd function hands back only the projection's gradient."""
    inp = _inputs()
    BV, M = 2, 50
    proj = torch.from_numpy(rng.uniform(-5, H + 5, size=(BV, M, 2))
                            .astype(np.float32))
    args = (proj, torch.from_numpy(inp["rc"]), torch.from_numpy(inp["rw"]),
            tsil.mask_crops_bits(torch.from_numpy(inp["crops"])),
            torch.from_numpy(inp["origins"]),
            torch.from_numpy(inp["vvalid"]))
    K.reset_launch_counts()
    out = K.mask_terms_forward(*args, IMSIZE, 10.0, (H, H))
    ref = K.mask_terms_forward_plain(*args, IMSIZE, 10.0, (H, H))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    sums, idx, pix, vert = out
    assert sums.shape == (2, BV) and idx.shape == (BV, 64)
    assert pix.shape == (BV, 4, 64) and vert.shape == (BV, 3, M)
    ones = torch.ones(BV)
    dproj = K.mask_terms_backward(idx, pix, vert, ones, ones, args[5],
                                  (1.0, 1.0))
    assert torch.equal(dproj, K.mask_terms_backward_plain(
        idx, pix, vert, ones, ones, args[5], (1.0, 1.0)))
    assert K.launch_counts()["mask_terms_forward"] == 0
    assert K.launch_counts()["mask_terms_backward"] == 0
    p = proj.clone().requires_grad_(True)
    icp, binary = tsil.MaskViewTerms.apply(p, *args[1:], IMSIZE, 10.0,
                                           (H, H))
    (icp.sum() + binary.sum()).backward()
    q = proj.clone().requires_grad_(True)
    si, sb = tsil.separate_view_terms(
        q, *args[1:], imsize=IMSIZE, epsilon=10.0, full_hw=(H, H))
    (si.sum() + sb.sum()).backward()
    torch.testing.assert_close(icp, si, rtol=1e-6, atol=0)
    torch.testing.assert_close(binary, sb, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p.grad, q.grad, rtol=0,
                               atol=2e-6 * float(q.grad.abs().max()))


def test_staged_f64_fits_agree_across_routes(monkeypatch):
    """A staged mask fit in f64 (30 steps, the mask term on after step
    10) under "fused" and "separate": the same trajectory."""
    from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
    from bodyfitting_tpu.models import body_model as jbm
    from tests.test_torch_fit import N_FRAMES, _config, _problem
    from tests.torch_port_util import torch_model, torch_obs, torch_prior

    model = jbm.synthetic_model("smplx", num_verts=400, seed=7)
    tm = torch_model(model, dtype=torch.float64)
    obs = tfit.concat_frames([torch_obs(o, dtype=torch.float64)
                              for o in _problem(model)])
    prior = torch_prior(synthetic_gmm_prior(), dtype=torch.float64)
    cfg = tfit.FitConfig(**dict(_config(), num_iters=30))
    runs = []
    fused_calls = _counted(monkeypatch, tsil, "mask_terms_forward")
    old = tsil.FUSED_MASK_TERM
    try:
        for route in ("separate", "fused"):
            tsil.FUSED_MASK_TERM = route
            init = tfit.FitParams.init(tm, batch=N_FRAMES)
            runs.append(tfit.fit(tm, cfg, obs, init, prior))
    finally:
        tsil.FUSED_MASK_TERM = old
    (ps, _, ls), (pf, _, lf) = runs
    assert ls.dtype == torch.float64 and ls.shape == (N_FRAMES, 30)
    assert len(fused_calls) == 30 - 11     # a fused term a post-gate step
    np.testing.assert_allclose(lf.numpy(), ls.numpy(), rtol=1e-7)
    for a, b in zip(pf.tensors(), ps.tensors()):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=0,
            atol=1e-7 * max(1.0, float(b.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [False, True], ids=["f32 crops",
                                                      "bit-mask crops"])
def test_kernels_match_plain_on_the_card(bits):
    """Both kernels bitwise their plain versions on the card: every
    per-point output, the per-view sums (the same tree order) and dproj;
    two forward launches and one backward launch for all views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    inp = _inputs()
    verts = _nan_verts((rng.normal(size=(4, 700, 3)) * 0.4)
                       .astype(np.float32))
    w2cs, Ks = (torch.from_numpy(np.tile(a, (4, 1, 1, 1)))
                for a in (inp["w2cs"], inp["Ks"]))
    from bodyfitting_torch.ops.camera import perspective_projection

    proj = perspective_projection(
        torch.from_numpy(verts)[:, None], w2cs[..., :3, :3],
        w2cs[..., :3, 3], Ks).reshape(8, -1, 2)
    crops = torch.from_numpy(np.tile(inp["crops"], (4, 1, 1)))
    args = [proj, torch.from_numpy(np.tile(inp["rc"], (4, 1, 1))),
            torch.from_numpy(np.tile(inp["rw"], (4, 1))),
            tsil.mask_crops_bits(crops) if bits else crops,
            torch.from_numpy(np.tile(inp["origins"], (4, 1))),
            torch.from_numpy(np.tile(inp["vvalid"], 4))]
    args = [a.to(dev).contiguous() for a in args]
    K.reset_launch_counts()
    got = K.mask_terms_forward(*args, IMSIZE, 10.0, (H, H))
    ref = K.mask_terms_forward_plain(*args, IMSIZE, 10.0, (H, H))
    g = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).to(dev)
    scale = (1.0, 1.0)
    dk = K.mask_terms_backward(*got[1:], g[0], g[1], args[5], scale)
    dp = K.mask_terms_backward_plain(*ref[1:], g[0], g[1], args[5], scale)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(dk), torch.nan_to_num(dp))
    assert torch.equal(torch.isnan(dk), torch.isnan(dp))
    assert K.launch_counts()["mask_terms_forward"] == 2
    assert K.launch_counts()["mask_terms_backward"] == 1


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """On the card a wrong dtype, and sums that pass the kernel's shared
    memory, raise: there is no fallback to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")

    def args(M, P=64, dtype=torch.float32):
        return [torch.zeros((1, M, 2), dtype=dtype, device=dev),
                torch.zeros((1, P, 2), device=dev),
                torch.ones((1, P), device=dev),
                torch.zeros((1, 8, 1), dtype=torch.int32, device=dev),
                torch.zeros((1, 2), device=dev), torch.ones(1, device=dev)]

    with pytest.raises(ValueError, match="float32"):
        K.mask_terms_forward(*args(100, dtype=torch.float64), IMSIZE, 10.0,
                             (H, H))
    with pytest.raises(ValueError, match="shared memory"):
        K.mask_terms_forward(*args(40_000), IMSIZE, 10.0, (H, H))
    K.mask_terms_forward(*args(16_384, P=512), IMSIZE, 10.0, (H, H))
    torch.cuda.synchronize()
