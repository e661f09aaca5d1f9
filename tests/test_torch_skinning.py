"""The port's fused skinning (plain version, on the CPU) against the JAX
package's ``skinning_xla`` and ``make_fused_skinning`` in interpret mode,
and ``body_model.forward`` with ``FUSED_SKINNING = "on"`` in both
packages.

Tolerances: forward 2e-6 absolute (J-term f32 sums in another order than
XLA's dot; outputs of order 1); gradients 1e-5 relative to the largest
entry (``dA`` sums ~V terms per tile, then tiles, XLA sums in one dot);
``forward`` with the kernel on 2e-6 against JAX with its kernel on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_tpu.ops import pallas_kernels as pk
from bodyfitting_torch.models import body_model as pbm
from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops.kernels import skinning as S
from torch_port_util import torch_model


def _data(V, J, B, seed):
    rng = np.random.default_rng(seed)
    W = rng.random((V, J)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    W[::37] = 0.0                                   # rows with no weight
    A = rng.normal(size=(B, J, 12)).astype(np.float32)
    vp = rng.normal(size=(B, V, 3)).astype(np.float32)
    g = rng.normal(size=(B, V, 3)).astype(np.float32)
    return W, A, vp, g


def _jax_skin(W, A, vp, g, fused):
    Wj = jnp.asarray(W)
    if fused:
        skin = pk.make_fused_skinning(Wj, vert_tile=256, interpret=True)
    else:
        def skin(a, v):
            return pk.skinning_xla(Wj, a, v)

    @jax.jit
    def fwd_bwd(a, v, gv):
        out, vjp = jax.vjp(jax.vmap(skin), a, v)
        return (out,) + vjp(gv)

    return [np.asarray(x) for x in fwd_bwd(jnp.asarray(A), jnp.asarray(vp),
                                           jnp.asarray(g))]


@pytest.mark.parametrize("J,V", [(24, 777), (55, 777), (55, 300)])
def test_plain_skinning_matches_jax(J, V):
    W, A, vp, g = _data(V, J, 3, seed=J + V)
    At = torch.tensor(A, requires_grad=True)
    vpt = torch.tensor(vp, requires_grad=True)
    out = K.fused_skinning(torch.tensor(W), At, vpt)
    dA, dvp = torch.autograd.grad(out, [At, vpt], torch.tensor(g))
    got = [out.detach().numpy(), dA.numpy(), dvp.numpy()]
    for fused in (False, True):
        ref = _jax_skin(W, A, vp, g, fused)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-6)
        for a, b in zip(got[1:], ref[1:]):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,V,J", [(8, 564, 55), (8, 3035, 55),
                                   (8, 10475, 55), (128, 10475, 55),
                                   (130, 1031, 64), (3, 1, 24), (1, 0, 55)])
def test_launch_geometry_covers_each_pair_once(B, V, J, backward):
    """The kernels' launch geometry (each of the backward's two, and the
    one it takes by size): whole warps a frame, at most 1,024 / VR threads
    (the kernels' launch bounds) and 227 KB of shared memory a block, the
    backward's vertex tile the dA contract's; the blocks' threads (thread
    t < (TV / VR) FB owns vertices t mod (TV / VR) + r TV / VR, r < VR, of
    frame t div (TV / VR)) cover every (vertex, frame) exactly once."""
    by_size = S.launch_geometry(B, V, J, backward)
    if backward:
        both = [S.launch_geometry(B, V, J, True, w) for w in (0, 1)]
        assert by_size == both[B >= S.WIDE_FRAMES and B * V >= S.WIDE_PAIRS]
        assert [g["CW"] for g in both] == [4, 12]
    else:
        both = [by_size]
    for geo in both:
        TV, FB, VR, threads = geo["TV"], geo["FB"], geo["VR"], geo["threads"]
        tpf = TV // VR
        assert TV % (32 * VR) == 0 and tpf * FB <= threads <= 1024 // VR
        assert threads % 32 == 0 and (backward or threads == tpf * FB)
        assert geo["smem_bytes"] <= 227 * 1024 - 16     # beside 16 static
        assert geo["smem_bytes"] == 4 * (TV * J + FB * J * 12
                                         + backward * FB * TV * 12)
        if backward:
            assert TV == S.TILE
            assert threads == tpf * FB + 32 * FB * 12 // geo["CW"]
        nx = max(1, -(-V // TV)) if backward else -(-V // TV)
        ny = -(-B // FB)
        assert geo["blocks"] == nx * ny
        count = np.zeros((B, V), np.int64)
        t = np.arange(threads)
        t = t[t // tpf < FB]                # later warps own no vertex
        for bx in range(nx):
            for by in range(ny):
                for r in range(VR):
                    v, b = bx * TV + t % tpf + r * tpf, by * FB + t // tpf
                    ok = (v < V) & (b < B)
                    np.add.at(count, (b[ok], v[ok]), 1)
        assert (count == 1).all()


def test_backward_plain_is_the_stated_order():
    """``dA`` is the sum, in tile order, of per-tile sums of 128
    vertices: bitwise the same as that order written out vertex by
    vertex in f32."""
    W, A, vp, g = _data(300, 24, 2, seed=3)
    t = [torch.tensor(x) for x in (W, A, vp, g)]
    dA, _ = S.skin_backward_plain(*t)
    M = []
    for r in range(3):
        gr = t[3][..., r]
        M += [gr * t[2][..., 0], gr * t[2][..., 1], gr * t[2][..., 2], gr]
    M = torch.stack(M, -1)
    parts = []
    for s in range(0, 300, S.TILE):
        acc = torch.zeros(2, 24, 12)
        for v in range(s, min(s + S.TILE, 300)):
            acc = acc + t[0][v][None, :, None] * M[:, v][:, None, :]
        parts.append(acc)
    ref = parts[0] * 0.0
    for p in parts:
        ref = ref + p
    assert torch.equal(dA, ref)


def _fit_state(model_np, seed=2):
    rng = np.random.default_rng(seed)
    return dict(
        betas=rng.normal(scale=0.5, size=(10,)).astype(np.float32),
        body_pose=rng.normal(scale=0.2, size=(63,)).astype(np.float32),
        global_orient=np.asarray([0.1, 0.2, -0.3], np.float32),
    )


def test_forward_with_the_switch_on_matches_jax(monkeypatch):
    jm = jbm.synthetic_model("smplx", num_verts=300, seed=0)
    pm = torch_model(jm)
    st = _fit_state(jm)
    jp = dataclasses.replace(jbm.BodyParams.zeros(jm), **{
        k: jnp.asarray(v) for k, v in st.items()})
    pp = dataclasses.replace(pbm.BodyParams.zeros(pm), **{
        k: torch.tensor(v)[None] for k, v in st.items()})

    orig = pk.make_fused_skinning
    monkeypatch.setattr(pk, "make_fused_skinning", lambda w, **kw: orig(
        w, interpret=True, **{k: v for k, v in kw.items()
                              if k != "interpret"}))
    monkeypatch.setattr(jbm, "FUSED_SKINNING", "on")
    monkeypatch.setattr(pbm, "FUSED_SKINNING", "on")
    ref = np.asarray(jax.jit(lambda p: jbm.forward(jm, p).vertices)(jp))
    K.reset_launch_counts()
    calls = []
    real = S.FusedSkinning.apply
    monkeypatch.setattr(S.FusedSkinning, "apply",
                        lambda *a: calls.append(1) or real(*a))
    got = pbm.forward(pm, pp).vertices[0].numpy()
    assert calls == [1]                          # the fused route ran
    assert K.launch_counts()["skin_forward"] == 0   # CPU: plain version
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    monkeypatch.setattr(pbm, "FUSED_SKINNING", "auto")
    off = pbm.forward(pm, pp).vertices[0].numpy()
    np.testing.assert_allclose(off, ref, rtol=0, atol=2e-6)
    assert calls == [1]                          # "auto" is the matmul


def test_f64_weights_take_the_matmul_path(monkeypatch):
    jm = jbm.synthetic_model("smplx", num_verts=200, seed=1)
    pm = torch_model(jm, dtype=torch.float64)
    monkeypatch.setattr(pbm, "FUSED_SKINNING", "on")
    monkeypatch.setattr(jbm, "FUSED_SKINNING", "on")

    def refuse(*a, **k):
        raise AssertionError("the fused kernel ran on f64 weights")

    monkeypatch.setattr(S, "fused_skinning", refuse)
    monkeypatch.setattr(pk, "make_fused_skinning", refuse)
    assert not pbm._use_fused_skinning(pm)
    pbm.forward(pm, pbm.BodyParams.zeros(pm))
    with jax.enable_x64(True):
        jm64 = dataclasses.replace(jm, lbs_weights=jnp.asarray(
            np.asarray(jm.lbs_weights), jnp.float64))
        assert not jbm._use_fused_skinning(jm64)
    assert pbm._use_fused_skinning(torch_model(jm))


def test_fit_step_with_the_kernel_switch_agrees(monkeypatch):
    """One keypoint fit's loss trace with ``"on"`` against ``"auto"`` on
    the port (CPU): the skinning sums in another order, so the f32
    traces agree to 1e-5 over 8 steps, not bitwise."""
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior

    pm = torch_model(jbm.synthetic_model("smplx", num_verts=300, seed=3))
    prior = synthetic_gmm_prior(device="cpu")
    rng = np.random.default_rng(4)
    obs = smplify.Observations(
        w2cs=torch.eye(4).expand(1, 4, 4, 4).clone(),
        Ks=torch.tensor([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]]).expand(
            1, 4, 3, 3).clone(),
        keypoints=torch.tensor(np.concatenate([
            rng.uniform(20, 44, (1, 4, 135, 2)),
            np.full((1, 4, 135, 1), 0.8)], -1), dtype=torch.float32),
        view_mask=torch.ones(1, 4), constant_scale=torch.tensor([0.3]),
        num_views_used=torch.tensor([4.0]))
    obs = dataclasses.replace(obs, w2cs=obs.w2cs.clone())
    obs.w2cs[..., 2, 3] = 3.0
    cfg = smplify.FitConfig(num_iters=8)
    traces = {}
    for mode in ("auto", "on"):
        monkeypatch.setattr(pbm, "FUSED_SKINNING", mode)
        init = smplify.FitParams.init(pm)
        _, _, losses = smplify.fit(pm, cfg, obs, init, prior)
        traces[mode] = losses.numpy()
    np.testing.assert_allclose(traces["on"], traces["auto"], rtol=1e-5)
