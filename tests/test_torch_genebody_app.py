"""The port's GeneBody app against the JAX app on one synthetic on-disk
subject (48 views, 2 frames at 64², a 64-vertex synthetic model, a few
iterations; the JAX app test's fixture), and the pieces only the port's
app reaches: the pipelined loop, HMR, the temporal loss, the flags it
refuses.

Tolerances: the saved parameters agree to 1e-5 absolute, the loss
traces to 1e-5 relative (f32 fits of 10 steps whose sums run in other
orders; measured ~3e-7); OBJ lines are byte-equal except where a value
sits on a rounding boundary of ``%.4f`` (then within 1e-4).  HMR agrees
with the Flax HMR on converted weights to 1e-5; through the image
preprocessing (the port's cubic resize is within one level of OpenCV's)
to 2e-3.  On a subject whose images are JPEGs the apps write equal
crops for the views without OpenPose JSONs.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_torch.apps import genebody as papp
from bodyfitting_torch.io.cameras import save_annots
from bodyfitting_torch.io.png import write_png

SUBJECT = "testsub"
SIZE = 64
N_VIEWS, N_FRAMES = 48, 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX app test's subject, written with the port's writers (PNG
    images and masks, ``annots.npy``)."""
    root = tmp_path_factory.mktemp("genebody_data")
    rng = np.random.default_rng(0)
    sub = root / "genebody" / SUBJECT
    Ks = np.broadcast_to(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]],
                                  np.float32), (N_VIEWS, 3, 3)).copy()
    RTs = []
    for v in range(N_VIEWS):
        th = 2 * np.pi * v / N_VIEWS
        eye = np.array([3 * np.sin(th), 0, 3 * np.cos(th)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = eye
        RTs.append(c2w)
    sub.mkdir(parents=True)
    save_annots(str(sub / "annots.npy"), Ks, np.stack(RTs))
    for v in range(N_VIEWS):
        (sub / "image" / ("%02d" % v)).mkdir(parents=True)
        (sub / "mask" / ("%02d" % v)).mkdir(parents=True)
        for fr in range(N_FRAMES):
            img = rng.integers(60, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)
            msk = np.zeros((SIZE, SIZE), np.uint8)
            msk[16:48, 20:44] = 255
            if v % 7 == 3:
                msk[20:30, 10 + fr:18] = 255
            write_png(str(sub / "image" / ("%02d" % v) / ("%04d.png" % fr)),
                      img)
            write_png(str(sub / "mask" / ("%02d" % v) / ("%04d.png" % fr)),
                      msk)
    return root


@pytest.fixture(scope="module")
def jpeg_dataset(tmp_path_factory, dataset):
    """``dataset`` with its images as JPEGs written by OpenCV (the JAX app
    test writes its subject's images as ``.jpg`` too)."""
    import cv2

    root = tmp_path_factory.mktemp("genebody_jpeg")
    shutil.copytree(dataset / "genebody", root / "genebody")
    sub = root / "genebody" / SUBJECT / "image"
    for png_path in sorted(sub.glob("*/*.png")):
        img = cv2.imread(str(png_path))
        assert cv2.imwrite(str(png_path.with_suffix(".jpg")), img,
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
        png_path.unlink()
    return root


def _write_jsons(out_dir, hand_face, seed=1, skip=()):
    """Per-view OpenPose JSONs for every view of every frame but the views
    in ``skip`` (the app's cache check then skips the binary)."""
    rng = np.random.default_rng(seed)
    for fr in range(N_FRAMES):
        d = os.path.join(out_dir, SUBJECT, "%06d" % fr, "openpose")
        os.makedirs(d, exist_ok=True)
        for v in range(N_VIEWS):
            def block(n):
                kp = rng.uniform(SIZE * 0.3, SIZE * 0.7, size=(n, 2))
                return np.concatenate([kp, np.full((n, 1), 0.9)],
                                      1).reshape(-1).tolist()
            person = {"pose_keypoints_2d": block(25)}
            if hand_face:
                person.update(hand_left_keypoints_2d=block(21),
                              hand_right_keypoints_2d=block(21),
                              face_keypoints_2d=block(70))
            if v in skip:
                continue
            with open(os.path.join(d, "%02d_keypoints.json" % v), "w") as f:
                json.dump({"people": [person]}, f)


def _argv(root, out, extra, iters=10, batch=2):
    return ["--target_dir", str(root / "genebody"), "--output_dir", str(out),
            "--subject", SUBJECT, "--load_size", str(SIZE),
            "--tasks", "openpose", "smplify", "output",
            "--num_iters", str(iters), "--batch_frames", str(batch),
            "--synthetic_num_verts", "64"] + extra


def _run_port(root, out, extra, **kw):
    _write_jsons(str(out), "smplx" in extra)
    papp.main(_argv(root, out, extra, **kw), device="cpu")


def _outputs(out):
    params = [np.load(str(out / SUBJECT / "param" / ("%04d.npy" % f)),
                      allow_pickle=True).item() for f in range(N_FRAMES)]
    objs = [open(out / SUBJECT / "smpl" / ("%04d.obj" % f)).read()
            for f in range(N_FRAMES)]
    trace = [json.loads(line) for line in open(out / SUBJECT /
                                                "loss_trace.jsonl")]
    return params, objs, sorted(trace, key=lambda r: r["frame"])


@pytest.mark.parametrize("extra", [
    [],
    ["--use_mask", "--temporal", "--timing"],
    ["--smpl_type", "smplx", "--smplx_with_smpl_init"],
], ids=["keypoints", "use_mask_temporal", "smplx_with_smpl_init"])
def test_port_app_matches_jax_app(dataset, tmp_path, extra):
    from bodyfitting_tpu.apps import genebody as japp

    outs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        if name == "port":
            _run_port(dataset, out, extra)
        else:
            _write_jsons(str(out), "smplx" in extra)
            japp.Runner(japp.config_parser().parse_args(
                _argv(dataset, out, extra))).run()
        outs[name] = _outputs(out)
    (jp, jo, jt), (pp, po, pt) = outs["jax"], outs["port"]
    for a, b in zip(jp, pp):
        assert set(a) == set(b) and {"vertices", "joints", "pose", "betas",
                                     "global_orient", "faces",
                                     "global_transl", "scale",
                                     "full_pose"} <= set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    for a, b in zip(jo, po):
        for la, lb in zip(a.splitlines(), b.splitlines()):
            if la != lb:
                assert la[0] == lb[0] == "v", (la, lb)
                np.testing.assert_allclose(
                    np.float64(lb.split()[1:]), np.float64(la.split()[1:]),
                    rtol=0, atol=1.0001e-4)
    assert [r["frame"] for r in jt] == [r["frame"] for r in pt] == [0, 1]
    for a, b in zip(jt, pt):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    if "--timing" in extra:
        timing = json.load(open(tmp_path / "port" / SUBJECT / "timing.json"))
        assert {"prep/images", "prep/observations", "fit/dispatch",
                "fit/device_wait", "write/outputs"} <= set(timing)


def test_port_app_matches_jax_app_on_jpeg_images(jpeg_dataset, tmp_path):
    """The subject's images are JPEGs: both apps decode them for the HMR
    keyframe (an HMR checkpoint whose first convolution is zero, so its
    output does not depend on the cubic resize, which is within one
    level of OpenCV's) and for the views without OpenPose JSONs, whose
    crops they write for the binary; those crops are equal, and the fits
    agree at the tolerances above."""
    from bodyfitting_tpu.apps import genebody as japp
    from bodyfitting_torch.models.hmr import seeded_state_dict

    ckpt = tmp_path / "hmr.pth"
    sd = seeded_state_dict(3)
    sd["conv1.weight"] = torch.zeros_like(sd["conv1.weight"])
    torch.save(sd, str(ckpt))
    skip = (4, 30)
    extra = ["--hmr_checkpoint", str(ckpt)]
    outs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        _write_jsons(str(out), False, skip=skip)
        argv = _argv(jpeg_dataset, out, extra, iters=6)
        argv.remove("openpose")                          # no binary here
        if name == "port":
            papp.main(argv, device="cpu")
        else:
            japp.Runner(japp.config_parser().parse_args(argv)).run()
        outs[name] = _outputs(out)
    (jp, jo, jt), (pp, po, pt) = outs["jax"], outs["port"]
    for a, b in zip(jp, pp):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    for a, b in zip(jt, pt):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    for fr in range(N_FRAMES):
        for v in skip:
            rel = os.path.join(SUBJECT, "%06d" % fr, "images", "%02d.png" % v)
            np.testing.assert_array_equal(
                papp.imread_checked(str(tmp_path / "port" / rel)),
                papp.imread_checked(str(tmp_path / "jax" / rel)))


def test_pipelined_equals_serial(dataset, tmp_path):
    got = {}
    for mode, workers in (("serial", "0"), ("pipelined", "2")):
        out = tmp_path / mode
        _run_port(dataset, out, ["--use_mask", "--prep_workers", workers],
                  iters=6, batch=1)
        got[mode] = _outputs(out)
    (sp, so, st), (pp, po, pt) = got["serial"], got["pipelined"]
    assert so == po and st == pt
    for a, b in zip(sp, pp):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the runs wrote the bbox and mask-crop caches
    frame_dir = tmp_path / "pipelined" / SUBJECT / "000000"
    assert (frame_dir / "bbox_cache.npy").exists()
    assert (frame_dir / f"mask_crops_{SIZE}.npz").exists()


def test_app_runs_hmr_on_the_keyframe(dataset, tmp_path):
    """With ``--hmr_checkpoint`` the keyframe's image (view 25) is decoded
    and cropped, and HMR's output seeds the fit: the first loss differs
    from the mean-pose run's."""
    from bodyfitting_torch.models.hmr import seeded_state_dict

    ckpt = tmp_path / "hmr.pth"
    sd = seeded_state_dict(3)
    sd["decpose.weight"] = sd["decpose.weight"] * 300.0   # a visible pose
    torch.save(sd, str(ckpt))
    firsts = {}
    for name, extra in (("mean", []), ("hmr", ["--hmr_checkpoint",
                                               str(ckpt)])):
        out = tmp_path / name
        _run_port(dataset, out, extra, iters=3)
        firsts[name] = [r["losses"][0] for r in _outputs(out)[2]]
        assert all(np.isfinite(firsts[name]))
    assert firsts["hmr"] != firsts["mean"]


def test_unported_options_raise(dataset, tmp_path, monkeypatch):
    for flag in ("--data_parallel", "--native_openpose"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            papp.main(_argv(dataset, tmp_path, [flag]), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp.main(_argv(dataset, tmp_path, []))
    from bodyfitting_torch.fitting import body_fitting as bf

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bf.fit_frames_batched_sharded()


def _seeded_flax_variables(model, rng, *args):
    """Flax variables for ``model`` drawn with numpy from their shapes (no
    compile of ``init``): Flax's default initialisers (lecun-normal
    kernels, zero biases, unit batch-norm scales), with batch statistics
    in [0.5, 1.5]."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("mean", "var"):
            x = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            x = np.full(s.shape, 1.0 if name == "scale" else 0.0)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_hmr_matches_flax_on_converted_weights():
    from bodyfitting_tpu.fitting import body_fitting as jbf
    from bodyfitting_tpu.models import hmr as jhmr
    from bodyfitting_torch.convert import hmr_state_dict_from_flax
    from bodyfitting_torch.fitting import body_fitting as pbf
    from bodyfitting_torch.models import hmr as phmr

    layers = (1, 1, 1, 1)
    model = jhmr.HMR(layers=layers)
    pose0, shape0, cam0 = jhmr.load_mean_params()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    v = _seeded_flax_variables(model, rng, jnp.asarray(x),
                               jnp.asarray(pose0)[None],
                               jnp.asarray(shape0)[None],
                               jnp.asarray(cam0)[None])
    net = phmr.HMR(layers)
    phmr.load_state_dict_checked(net, hmr_state_dict_from_flax(v))
    # the JAX package runs hmr_forward eagerly; jit it for the test's time
    model.apply = jax.jit(model.apply)
    ref = jhmr.hmr_forward(model, v, jnp.asarray(x))
    got = phmr.hmr_forward(net, torch.tensor(x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    # hmr_init through the image preprocessing and the keyframe rotation
    image = rng.integers(0, 256, (300, 260, 3)).astype(np.uint8)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    jb = jbf.HMRBundle(model=model, variables=v, mean_params=(pose0, shape0,
                                                             cam0))
    pb = pbf.HMRBundle(model=net, mean_params=(pose0, shape0, cam0))
    for a, b in zip(pbf.hmr_init(image, c2w, pb),
                    jbf.hmr_init(image, c2w, jb)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


def test_temporal_loss_matches_jax():
    from bodyfitting_tpu.fitting import sequence as jseq
    from bodyfitting_tpu.fitting import smplify as jsm
    from bodyfitting_tpu.models import body_model as jbm
    from bodyfitting_torch.fitting import sequence as pseq
    from torch_port_util import torch_params

    jm = jbm.synthetic_model("smpl", num_verts=64)
    rng = np.random.default_rng(2)
    F = 5
    init = jax.eval_shape(jax.vmap(lambda _: jsm.FitParams.init(jm)),
                          jnp.arange(F))
    body = {f.name: jnp.asarray(rng.normal(size=getattr(init.body,
                                                        f.name).shape),
                                jnp.float32)
            for f in __import__("dataclasses").fields(init.body)}
    params = jsm.FitParams(
        body=type(init.body)(**body),
        global_transl=jnp.asarray(rng.normal(size=(F, 3)), jnp.float32),
        body_scale=jnp.asarray(rng.normal(size=(F, 1)), jnp.float32))
    tcfg = jseq.TemporalConfig(acceleration_weight=3.0)
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    pparams = torch_params(params, batched=True)
    for fv in (None, valid):
        ref = float(jax.jit(jseq.temporal_loss, static_argnums=1)(
            params, tcfg, None if fv is None else jnp.asarray(fv)))
        got = float(pseq.temporal_loss(
            pparams, pseq.TemporalConfig(acceleration_weight=3.0),
            None if fv is None else torch.tensor(fv)))
        assert abs(got - ref) <= 1e-5 * abs(ref)
