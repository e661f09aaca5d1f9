"""The multi-device package (``bodyfitting_torch/parallel``) on gloo worlds
of CPU processes, against the port's unsharded functions and the JAX
package's sharded ones.

The ranks are processes spawned with ``torch.multiprocessing`` on a
``FileStore`` under ``tmp_path``: one world of 4 (the frames-only 4x1 and
the 2x2 ``(frames, views)`` fits, and the vertex-sharded body model) and
one of 2 (the padded batch and the temporal fit over a 2x1 mesh), each
spawned once per module and read by several tests.  The children import
neither JAX nor the JAX package (its imports sit inside the JAX-side
helpers here) and run one thread each.  The JAX side runs on conftest's
8-device CPU mesh, in f64 under ``jax.enable_x64``.

Tolerances, f64: the sharded fits and gradients equal the unsharded ones
up to summation order (1e-10; the 4x1 fit has no collective in its step,
and each rank's gradient equals that of its block fitted alone bitwise);
JAX's sharded fit to 1e-7 relative,
the drift of two operation orders over 20 Adam steps
(``tests/test_torch_fit.py``); the vertex-sharded forward 1e-12, its pad
rows exactly 0; ``pad_model_vertices`` and the production problem's
contours equal JAX's exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_FRAMES, N_VIEWS, NUM_VERTS, ITERS = 8, 4, 128, 20
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
TP_VERTS = 253                       # odd: auto-padded to 256 over 4 ranks


# ---------------------------------------------------------------------------
# The problem, from numpy (both packages)
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(11)
    K = np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[2, 3] = 3.0
    return dict(
        w2cs=np.broadcast_to(w2c, (N_FRAMES, N_VIEWS, 4, 4)).copy(),
        Ks=np.broadcast_to(K, (N_FRAMES, N_VIEWS, 3, 3)).copy(),
        keypoints=rng.uniform(50, 200, size=(N_FRAMES, N_VIEWS, 135, 3)),
        view_mask=np.ones((N_FRAMES, N_VIEWS)),
        constant_scale=np.full((N_FRAMES,), 0.3),
    )


def _torch_problem():
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.losses.priors import synthetic_gmm_prior
    from bodyfitting_torch.models import body_model as bm

    model = bm.synthetic_model("smplx", num_verts=NUM_VERTS, seed=8,
                               dtype=torch.float64, device="cpu")
    prior = synthetic_gmm_prior(dtype=torch.float64, device="cpu")
    config = smplify.FitConfig(num_iters=ITERS, imsize=256.0)
    obs = smplify.Observations(**{k: torch.as_tensor(v)
                                  for k, v in _arrays().items()})
    init = smplify.FitParams.init(model, batch=N_FRAMES)
    return model, config, obs, init, prior


def _grads(model, config, obs, params, prior, step, view_group=None):
    """The fit loss's gradient at ``params`` (the port's step body)."""
    from bodyfitting_torch.fitting import smplify

    leaves = [t.detach().clone().requires_grad_(True)
              for t in params.tensors()]
    lm, jm, rows = smplify.loss_models(model, config)
    loss, _ = smplify.fit_loss(lm, config,
                               smplify.FitParams.from_tensors(leaves), obs,
                               step, prior, joints_model=jm,
                               mask_vertex_rows=rows, view_group=view_group)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _tp_params(model):
    from bodyfitting_torch.models import body_model as bm

    rng = np.random.default_rng(4)
    return dataclasses.replace(
        bm.BodyParams.zeros(model),
        body_pose=torch.as_tensor(rng.normal(size=(1, 63)) * 0.2),
        betas=torch.as_tensor(rng.normal(size=(1, 10))),
        expression=torch.as_tensor(rng.normal(size=(1, 10)) * 0.5))


def _tp_outputs(model, params):
    """Vertices, joints and the gradient of a loss on both."""
    from bodyfitting_torch.models import body_model as bm

    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in ("betas", "body_pose", "expression")}
    out = bm.forward(model, dataclasses.replace(params, **leaves))
    w = torch.linspace(-1.0, 1.0, TP_VERTS, dtype=torch.float64)[:, None]
    loss = ((out.vertices[0, :TP_VERTS] * w).square().sum()
            + out.joints.square().sum())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(vertices=out.vertices.detach(), joints=out.joints.detach(),
                grads=[g.detach() for g in grads])


# ---------------------------------------------------------------------------
# The ranks (module level: spawned children import this module)
# ---------------------------------------------------------------------------

def _job_fits(rank, out_dir):
    """World of 4: the 4x1 and 2x2 fits with their gradients at two
    states, and the vertex-sharded forward."""
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import comm
    from bodyfitting_torch.parallel import sharding as sh
    from bodyfitting_torch.parallel import tensor as tp

    model, config, obs, init, prior = _torch_problem()
    saved = {}
    for name, (nf, nv) in MESHES.items():
        mesh = sh.make_mesh(nf, nv)
        comm.LOG = []
        params, result, losses = sh.fit_sequence_sharded(
            model, config, obs, init, prior, mesh=mesh)
        fit_log, comm.LOG = [e[0] for e in comm.LOG], None
        frames, _, _ = sh.axis(mesh, "frames")
        views, _, _ = sh.axis(mesh, "views")
        grads = []
        for state, step in ((init, 0), (params, ITERS - 1)):
            g = _grads(model, config, sh.obs_sharding(mesh, obs),
                       sh.params_sharding(mesh, state), prior, step, views)
            grads.append([comm.raw_all_gather(t, frames) for t in g])
        saved[name] = dict(params=params.tensors(), result=result,
                           losses=losses, grads=grads, log=fit_log)
    mesh = tp.make_tp_mesh()
    full = bm.synthetic_model("smplx", num_verts=TP_VERTS, seed=5,
                              dtype=torch.float64, device="cpu")
    sharded = tp.shard_model_vertices(full, mesh)
    params = tp.replicate_params(_tp_params(full), mesh)
    saved["tp"] = dict(_tp_outputs(sharded, params),
                       local_rows=sharded.v_template.shape[0])
    if rank == 0:
        torch.save(saved, os.path.join(out_dir, "fits.pt"))


def _job_padding(rank, out_dir):
    """World of 2: a 3-frame batch and a 3-frame temporal fit over the
    2x1 mesh (one padding frame on rank 1)."""
    from bodyfitting_torch.fitting import body_fitting as bf
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.parallel import sharding as sh

    model, config, obs, init, prior = _torch_problem()
    obs_list = [_frame(obs, i) for i in range(3)]
    init_list = [_frame(init, i) for i in range(3)]
    mesh = sh.make_mesh(2, 1)
    params, result, losses = bf.fit_frames_batched_sharded(
        model, config, obs_list, init_list, prior, mesh=mesh)
    results, seq_losses = bf.fit_sequence_batched(
        model, dataclasses.replace(config, num_iters=12), obs_list,
        init_list, prior, mesh=mesh)
    if rank == 0:
        torch.save(dict(params=params.tensors(), result=result,
                        losses=losses, seq_results=results,
                        seq_losses=seq_losses),
                   os.path.join(out_dir, "padding.pt"))
    assert isinstance(params, smplify.FitParams)


def _frames(item, lo, hi):
    """Frames ``lo:hi`` of a dataclass of ``[B, ...]`` tensors."""
    return type(item)(**{
        f.name: (_frames(v, lo, hi) if dataclasses.is_dataclass(v)
                 else None if v is None else v[lo:hi])
        for f in dataclasses.fields(item)
        for v in (getattr(item, f.name),)})


def _frame(item, i):
    return _frames(item, i, i + 1)


def _rank_main(rank, world, store_path, out_dir, job):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        {"fits": _job_fits, "padding": _job_padding}[job](rank, out_dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_app(rank, world, port, argv):
    """One rank of the GeneBody app as ``torchrun`` starts it (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous on this host)."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from bodyfitting_torch.apps import genebody as papp

    try:
        papp.main(argv, device="cpu")
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path_factory, job, world):
    d = tmp_path_factory.mktemp(job)
    mp.spawn(_rank_main, args=(world, str(d / "store"), str(d), job),
             nprocs=world, join=True)
    return torch.load(d / f"{job}.pt", weights_only=False)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    return _spawn(tmp_path_factory, "fits", 4)


@pytest.fixture(scope="module")
def padding(tmp_path_factory):
    return _spawn(tmp_path_factory, "padding", 2)


@pytest.fixture(scope="module")
def unsharded():
    from bodyfitting_torch.fitting import smplify

    model, config, obs, init, prior = _torch_problem()
    params, result, losses = smplify.fit(model, config, obs, init, prior)
    grads = [_grads(model, config, obs, state, prior, step)
             for state, step in ((init, 0), (params, ITERS - 1))]
    return dict(params=params.tensors(), result=result, losses=losses,
                grads=grads)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# Frame and view sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_fit_matches_unsharded(fits, unsharded, mesh):
    got = fits[mesh]
    _close(got["losses"], unsharded["losses"], 1e-10)
    _close(got["result"]["vertices"], unsharded["result"]["vertices"], 1e-10)
    for a, b in zip(got["params"], unsharded["params"]):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_gradients_match_unsharded(fits, unsharded, mesh):
    """Each term counted once: the gradient of the split fit equals the
    whole fit's, at the start and at the last step."""
    for got, want in zip(fits[mesh]["grads"], unsharded["grads"]):
        for a, b in zip(got, want):
            _close(a, b, 1e-10)
    if mesh == "4x1":
        # no collective in the step: each rank's block equals the
        # unsharded gradient of that block alone, bit for bit
        model, config, obs, init, prior = _torch_problem()
        blocks = [_grads(model, config, _frames(obs, i, i + 2),
                         _frames(init, i, i + 2), prior, 0)
                  for i in range(0, N_FRAMES, 2)]
        for a, *parts in zip(fits[mesh]["grads"][0], *blocks):
            assert torch.equal(a, torch.cat(parts))


def test_collectives_counted(fits):
    """The frames-only fit gathers its results once; the 2x2 fit adds two
    all-reduces a step (the view sum and the joints' gradient)."""
    n_out = len(fits["4x1"]["params"]) + len(fits["4x1"]["result"]) + 1
    assert fits["4x1"]["log"] == ["all_gather"] * n_out
    log = fits["2x2"]["log"]
    assert log.count("all_gather") == n_out
    assert log == ["all_reduce"] * (2 * ITERS) + ["all_gather"] * n_out


def _jax_sharded_fit(nf, nv):
    import jax
    import jax.numpy as jnp

    from bodyfitting_tpu.fitting import smplify as jfit
    from bodyfitting_tpu.losses.priors import synthetic_gmm_prior
    from bodyfitting_tpu.models import body_model as jbm
    from bodyfitting_tpu.parallel import sharding as jsh

    with jax.enable_x64(True):
        def f64(t):
            return jax.tree.map(
                lambda x: x.astype(jnp.float64)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, t)

        model = f64(jbm.synthetic_model("smplx", num_verts=NUM_VERTS,
                                        seed=8))
        prior = synthetic_gmm_prior(dtype=jnp.float64)
        config = jfit.FitConfig(num_iters=ITERS, imsize=256.0)
        obs = jfit.Observations(**{k: jnp.asarray(v)
                                   for k, v in _arrays().items()})
        init = jax.tree.map(lambda x: jnp.stack([x] * N_FRAMES),
                            f64(jfit.FitParams.init(model)))
        mesh = jsh.make_mesh(nf, nv, devices=jax.devices()[:nf * nv])
        _, res, losses = jsh.fit_sequence_sharded(model, config, obs, init,
                                                  prior, mesh=mesh)
        return np.asarray(res["vertices"]), np.asarray(losses)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_fit_matches_jax(fits, mesh):
    verts, losses = _jax_sharded_fit(*MESHES[mesh])
    assert losses.dtype == np.float64
    np.testing.assert_allclose(fits[mesh]["losses"].numpy(), losses,
                               rtol=1e-7)
    _close(fits[mesh]["result"]["vertices"], verts, 1e-7)


def test_frames_batched_sharded_pads_and_strips(padding):
    """3 frames on 2 ranks: the last frame repeated once on rank 1, every
    output cut back to 3 frames and equal to the unsharded batch's."""
    from bodyfitting_torch.fitting import body_fitting as bf

    model, config, obs, init, prior = _torch_problem()
    params, result, losses = bf.fit_frames_batched(
        model, config, [_frame(obs, i) for i in range(3)],
        [_frame(init, i) for i in range(3)], prior)
    assert padding["losses"].shape == (3, ITERS)
    _close(padding["losses"], losses, 1e-10)
    assert set(padding["result"]) == set(result)
    for k, v in result.items():
        assert padding["result"][k].shape == v.shape, k
        _close(padding["result"][k], v, 1e-10)
    for a, b in zip(padding["params"], params.tensors()):
        assert a.shape[0] == 3
        _close(a, b, 1e-10)


def test_temporal_padding_frames_are_inert(padding):
    """The 3-frame temporal fit over the 2x1 mesh (a padding frame on rank
    1, the temporal terms across the shard boundary) equals the unsharded
    temporal fit of the 3 frames."""
    from bodyfitting_torch.fitting import body_fitting as bf

    model, config, obs, init, prior = _torch_problem()
    results, losses = bf.fit_sequence_batched(
        model, dataclasses.replace(config, num_iters=12),
        [_frame(obs, i) for i in range(3)],
        [_frame(init, i) for i in range(3)], prior)
    assert padding["seq_losses"].shape == losses.shape == (12,)
    _close(padding["seq_losses"], losses, 1e-10)
    for k, v in results.items():
        assert padding["seq_results"][k].shape == v.shape, k
        _close(padding["seq_results"][k], v, 1e-10)


# ---------------------------------------------------------------------------
# The vertex-sharded body model
# ---------------------------------------------------------------------------

def test_pad_model_vertices_equals_jax():
    from bodyfitting_tpu.models import body_model as jbm
    from bodyfitting_tpu.parallel import tensor as jtp
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.parallel import tensor as tp

    for kind, V in (("smplx", 253), ("smpl", 130)):
        want = jtp.pad_model_vertices(
            jbm.synthetic_model(kind, num_verts=V, seed=7), 8)
        got = tp.pad_model_vertices(
            bm.synthetic_model(kind, num_verts=V, seed=7, device="cpu"), 8)
        assert got.v_template.shape[0] == -(-V // 8) * 8
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if hasattr(a, "shape"):
                assert np.array_equal(np.asarray(a), b.numpy()), (kind,
                                                                  f.name)


def test_vertex_sharded_forward_matches_unsharded(fits):
    from bodyfitting_torch.models import body_model as bm

    full = bm.synthetic_model("smplx", num_verts=TP_VERTS, seed=5,
                              dtype=torch.float64, device="cpu")
    want = _tp_outputs(full, _tp_params(full))
    got = fits["tp"]
    assert got["local_rows"] == 64
    assert got["vertices"].shape == (1, 256, 3)
    assert torch.all(got["vertices"][:, TP_VERTS:] == 0)
    _close(got["vertices"][:, :TP_VERTS], want["vertices"], 1e-12)
    _close(got["joints"], want["joints"], 1e-12)
    for a, b in zip(got["grads"], want["grads"]):
        _close(a, b, 1e-12)


def test_shard_model_vertices_refuses_without_padding():
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.parallel import tensor as tp

    class _Mesh:
        mesh_dim_names = ("tp",)
        shape = (4,)

        def get_local_rank(self, axis):
            return 0

    model = bm.synthetic_model("smpl", num_verts=130, seed=1, device="cpu")
    with pytest.raises(ValueError, match="pad_model_vertices"):
        tp.shard_model_vertices(model, _Mesh(), auto_pad=False)
    with pytest.raises(ValueError, match="joints reduction"):
        tp.shard_model_vertices(bm.reduce_for_joints(model), _Mesh())


# ---------------------------------------------------------------------------
# The world, the mesh and the production problem
# ---------------------------------------------------------------------------

def test_make_mesh_needs_a_world():
    from bodyfitting_torch.parallel import sharding as sh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_world"):
        sh.make_mesh()


def test_world_of_one_in_process():
    from bodyfitting_torch.parallel import sharding as sh

    assert sh.init_world("cpu") == torch.device("cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = sh.make_mesh()
        assert mesh.mesh_dim_names == ("frames", "views")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="2 x 1 != 1"):
            sh.make_mesh(2, 1)
    finally:
        dist.destroy_process_group()


def test_production_fit_problem_equals_jax(monkeypatch):
    """Every array of the problem equals JAX's (the contours exactly).
    Each package's volume build is recorded and stubbed: its inputs must
    be equal, and the builds themselves are held to each other by
    ``tests/test_torch_sdf.py``."""
    import jax.numpy as jnp

    from bodyfitting_tpu.ops import sdf as jsdf
    from bodyfitting_tpu.parallel import checks as jchecks
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.ops import sdf as tsdf
    from bodyfitting_torch.parallel import checks
    from tests.torch_port_util import arrays_of

    builds = {}

    def stub(name, mod, zeros):
        def build(verts, faces, resolution):
            builds[name] = (np.asarray(verts), np.asarray(faces), resolution)
            R = resolution
            return mod.DistanceVolume(dist=zeros((R, R, R)),
                                      face_idx=zeros((R, R, R)),
                                      origin=zeros((3,)), spacing=zeros(()))
        monkeypatch.setattr(mod, "build_distance_volume", build)

    stub("jax", jsdf, jnp.zeros)
    stub("port", tsdf, torch.zeros)
    jm, jcfg, jobs, jinit, _ = jchecks.make_production_fit_problem(
        np.random.default_rng(0), n_frames=2)
    tm, tcfg, tobs, tinit, _ = checks.make_production_fit_problem(
        np.random.default_rng(0), n_frames=2, device="cpu")
    assert tm.num_verts == 10475 and tcfg.use_mask and tcfg.use_mesh
    assert (tcfg.num_iters, tcfg.mesh_loss_impl, tcfg.imsize) == (
        jcfg.num_iters, jcfg.mesh_loss_impl, jcfg.imsize)
    (jv, jf, jr), (tv, tf, tr) = builds["jax"], builds["port"]
    assert jr == tr == 24
    assert np.array_equal(jv, tv) and np.array_equal(jf, tf)
    j = arrays_of(jobs)
    exact = ("contours", "contour_valid", "masks", "w2cs", "Ks", "mask_w2cs",
             "mask_Ks", "view_mask", "constant_scale", "scan_verts",
             "scan_faces", "scan_height")
    for k in exact:
        assert np.array_equal(getattr(tobs, k).numpy(), j[k]), k
    assert tobs.contours.shape == (2, 2, 256, 2)
    assert tobs.scan_volume.dist.shape == (2, 24, 24, 24)
    np.testing.assert_allclose(tobs.keypoints.numpy(), j["keypoints"],
                               rtol=0, atol=1e-4)
    want = [getattr(jinit.body, f) for f in bm.BODY_PARAM_FIELDS] + [
        jinit.global_transl, jinit.body_scale]
    for a, b in zip(tinit.tensors(), want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_training_step_is_the_fit_step():
    """``training_step`` runs the production step body: one step from the
    start equals a one-iteration fit, loss and parameters."""
    from bodyfitting_torch.fitting import smplify
    from bodyfitting_torch.parallel import sharding as sh

    model, config, obs, init, prior = _torch_problem()
    config = dataclasses.replace(config, num_iters=1)
    make_opt, step = sh.training_step(model, config, prior, step_idx=0)
    params = smplify.FitParams.from_tensors(
        [t.clone() for t in init.tensors()])
    got, loss = step(make_opt(params), obs)
    want, _, losses = smplify.fit(model, config, obs, init, prior)
    assert torch.equal(loss, losses[:, 0])
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a, b)


def test_data_parallel_app_over_two_launched_ranks(tmp_path):
    """``--data_parallel --io_cache`` as ``torchrun --nproc-per-node 2``
    runs it, on gloo: each rank fits its frame of the batch, rank 0 alone
    writes (the crop-box caches too, whole), and the outputs equal the
    single-process run's (rtol 2e-5, atol 1e-5, the JAX app test's
    tolerance: each rank fits at batch 1, the single run at batch 2)."""
    import socket

    from tests.test_torch_genebody_app import (
        _argv, _outputs, _run_port, _write_jsons, dataset as make_dataset)

    root = make_dataset.__wrapped__(_Factory(tmp_path / "data"))
    single = tmp_path / "single"
    _run_port(root, single, [], iters=6)
    out = tmp_path / "dp"
    _write_jsons(str(out), False)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = _argv(root, out, ["--data_parallel", "--io_cache"], iters=6)
    mp.spawn(_rank_app, args=(2, port, argv), nprocs=2, join=True)
    # rank 0 wrote each frame's crop boxes, whole, as the single run did
    caches = sorted(single.rglob("bbox_cache.npy"))
    assert caches and not list(out.rglob("*.tmp"))
    for path in caches:
        np.testing.assert_array_equal(
            np.load(out / path.relative_to(single)), np.load(path))
    (sp, _, st), (dp, _, dt) = _outputs(single), _outputs(out)
    for a, b in zip(sp, dp):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-5, atol=1e-5,
                                       err_msg=k)
    for a, b in zip(st, dt):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=2e-5)


class _Factory:
    """The one method of pytest's ``tmp_path_factory`` a fixture body
    calls."""

    def __init__(self, base):
        self.base = base

    def mktemp(self, name):
        path = self.base / name
        path.mkdir(parents=True)
        return path
