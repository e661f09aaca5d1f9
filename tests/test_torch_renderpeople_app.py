"""The port's RenderPeople app against the JAX app on one tiny textured
scan (the JAX app test's convex hull of 40 points, its texture a JPEG):
4 ring views at 64², 8 + 8 iterations of the SMPLify and SMPL+D fits,
6 texture-fit iterations, the 64-vertex synthetic SMPL model, with the
``--auto_uv`` atlas, and the texture stage with a UV template; and the
pieces around it: the ``--tasks texfit`` rerun on the cached views and
fit, ``--info_dir`` genders, ``render_compare``, and the ``--use_mask``
scan fit on full masks.

Tolerances: the saved parameters agree to 1e-5 absolute and the loss
traces to 1e-5 relative (f32 fits whose sums run in other orders;
measured ~1e-6 and ~6e-7), but for the SMPL+D displacement, held to
5e-5: the displacement stage amplifies rounding about 1.6x a step
(ROADMAP §3), so the body's ~1e-6 grows by up to 1.6^8 ~ 43 over its 8
steps (measured 1.5e-5 on one of 192 entries, 0.4 m in size); OBJ
lines are byte-equal except where a value sits on a rounding boundary of
``%.4f`` (then within 1e-4); masks are equal; images and the texture
PNGs within one level (a float32 value on the other side of a level's
boundary truncates one lower).  The texture stage is compared on the
same fit: the port's ``--tasks texfit output`` on a copy of the JAX
app's views and fit.  Its texture is within one level but at a few
texels (at most 1e-4 of the values; measured 11 and 4 of 3,145,728),
each within the 16 levels that Adam can move a texel in 6 steps of 1e-2:
where the pixels' signed L1 gradients on a texel cancel to ~0, Adam's
normalised step follows the sign of what rounding leaves (the two
packages' renders agree to 1e-5 and their face indices exactly).  Fed
the two apps' own fits (vertices 1e-6 apart) instead, a few hundred
texels differ so.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from bodyfitting_torch.apps import renderpeople as papp
from bodyfitting_torch.io.obj import save_obj_uv
from bodyfitting_torch.io.png import read_png

SIZE, VIEWS = 64, 4
SUBJECT = "subjectA"


def _write_scan(scan_dir, rng):
    """The JAX app test's scan (tests/test_apps.py), its texture written
    as a JPEG and named by the MTL's ``map_Kd``."""
    from scipy.spatial import ConvexHull

    scan_dir.mkdir(parents=True)
    pts = rng.normal(size=(40, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts[:, 1] *= 1.6
    faces = ConvexHull(pts).simplices.astype(np.int32)
    uvs = rng.uniform(size=(len(pts), 2)).astype(np.float32)
    tex = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    name = scan_dir.name
    save_obj_uv(str(scan_dir / f"{name}.obj"), pts.astype(np.float32), faces,
                uvs, faces)
    with open(scan_dir / f"{name}.mtl", "a") as f:
        f.write(f"map_Kd tex/{name}.jpg\n")
    (scan_dir / "tex").mkdir()
    cv2.imwrite(str(scan_dir / "tex" / f"{name}.jpg"),
                (tex[..., ::-1] * 255).astype(np.uint8),
                [cv2.IMWRITE_JPEG_QUALITY, 95])


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("rp")
    rng = np.random.default_rng(0)
    _write_scan(root / "scans" / SUBJECT, rng)
    # a UV template for the synthetic model: charts that do not overlap,
    # as in the licensed template (overlapping charts tie in the atlas
    # z-buffer, where rounding picks the face)
    from bodyfitting_torch.models import body_model as bm
    from bodyfitting_torch.utils.uv_unwrap import make_uv_template

    model = bm.synthetic_model("smpl", num_verts=64, device="cpu")
    (root / "smpl_uv").mkdir()
    make_uv_template(model.v_template.numpy(), model.faces.numpy(),
                     str(root / "smpl_uv" / "smpl_uv.obj"), margin_frac=0.2)
    return root


def _write_jsons(out_dir, subject=SUBJECT, seed=1):
    rng = np.random.default_rng(seed)
    d = os.path.join(out_dir, subject, "openpose")
    os.makedirs(d, exist_ok=True)
    for v in range(VIEWS):
        kp = rng.uniform(SIZE * 0.3, SIZE * 0.7, size=(25, 2))
        pose = np.concatenate([kp, np.full((25, 1), 0.9)], 1)
        with open(os.path.join(d, "%02d_keypoints.json" % v), "w") as f:
            json.dump({"people": [{"pose_keypoints_2d":
                                   pose.reshape(-1).tolist()}]}, f)


def _argv(root, out, extra, tasks=("openpose", "smplify", "smpld", "texfit",
                                   "output")):
    return ["--target_dir", str(root / "scans"), "--output_dir", str(out),
            "--load_size", str(SIZE), "--viewnum", str(VIEWS),
            "--tasks", *tasks, "--num_iters", "8", "--tex_iters", "6",
            "--synthetic_num_verts", "64", "--disp_map"] + extra


def _run(which, root, out, extra, **kw):
    _write_jsons(str(out))
    argv = _argv(root, out, extra, **kw)
    if which == "port":
        return papp.main(argv, device="cpu")
    from bodyfitting_tpu.apps import renderpeople as japp

    runner = japp.Runner(japp.config_parser().parse_args(argv))
    runner.run()
    return runner


def _png(path):
    return read_png(str(path))


def _assert_obj_close(a, b):
    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x != y:
            assert x.split()[0] == y.split()[0] == "v", (x, y)
            np.testing.assert_allclose(np.float64(y.split()[1:]),
                                       np.float64(x.split()[1:]), rtol=0,
                                       atol=1.0001e-4)


def _assert_within_one_level(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, what
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.max() <= 1, (what, int(d.max()), int((d > 1).sum()))


def _auto_uv(root):
    """The ``--auto_uv`` flags, with a UV template folder that does not
    exist."""
    return ["--auto_uv", "--smpl_uv_dir", str(root / "no_uv_template")]


@pytest.fixture(scope="module")
def full_runs(scans, tmp_path_factory):
    """Both apps' runs of every task (the OpenPose JSONs cached) with
    ``--auto_uv``: ``{"jax": output dir, "port": output dir}``."""
    root = tmp_path_factory.mktemp("full")
    outs = {w: root / w for w in ("jax", "port")}
    for w, out in outs.items():
        _run(w, scans, out, _auto_uv(root))
    return outs


def _texfit_on(which, scans, fit_dir, out, extra):
    """``which`` app's ``--tasks texfit output`` in ``out`` on the views,
    keypoints and fit of the output dir ``fit_dir``."""
    for d in ("images", "masks", "openpose", "smplify"):
        shutil.copytree(fit_dir / SUBJECT / d, out / SUBJECT / d)
    return _run(which, scans, out, extra, tasks=("texfit", "output"))


def _assert_texfit_close(a, b):
    """The texture stage's outputs under ``a`` and ``b`` (``texfit/``
    dirs), from the same views and fit, at the tolerances above."""
    for name in ("smpl.png", "smpl+d_textured.png"):
        x, y = _png(a / name), _png(b / name)
        assert x.shape == y.shape == (1024, 1024, 3)
        d = np.abs(x.astype(np.int16) - y.astype(np.int16))
        assert d.max() <= 16 and (d > 1).sum() <= 1e-4 * d.size, (
            name, int(d.max()), int((d > 1).sum()))
    _assert_within_one_level(_png(a / "smpl_dis.png"),
                             _png(b / "smpl_dis.png"), "smpl_dis.png")
    _assert_obj_close(a / "smpl+d_textured.obj", b / "smpl+d_textured.obj")
    assert (open(a / "smpl+d_textured.mtl").read()
            == open(b / "smpl+d_textured.mtl").read())


def test_port_app_matches_jax_app(scans, full_runs, tmp_path):
    outs = full_runs
    j, p = (outs[w] / SUBJECT for w in ("jax", "port"))
    # the prep: views rendered from the JPEG-textured scan
    for i in range(VIEWS):
        np.testing.assert_array_equal(_png(p / "masks" / ("%02d.png" % i)),
                                      _png(j / "masks" / ("%02d.png" % i)))
        _assert_within_one_level(_png(p / "images" / ("%02d.png" % i)),
                                 _png(j / "images" / ("%02d.png" % i)),
                                 f"view {i}")
    # the fit
    a = np.load(j / "smplify" / "smpl_parameter.npy", allow_pickle=True).item()
    b = np.load(p / "smplify" / "smpl_parameter.npy", allow_pickle=True).item()
    assert set(a) == set(b) and "displacement" in b
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(
            b[k], a[k], rtol=0, atol=5e-5 if k == "displacement" else 1e-5,
            err_msg=k)
    for rel in ("smplify/smpl.obj", "smplify/smpl+d.obj",
                "texfit/smpl+d_textured.obj"):
        _assert_obj_close(j / rel, p / rel)
    _assert_obj_close(outs["jax"] / "SMPL" / f"{SUBJECT}.obj",
                      outs["port"] / "SMPL" / f"{SUBJECT}.obj")
    assert (outs["port"] / "SMPL" / f"{SUBJECT}.npy").exists()
    ta, tb = (json.loads(open(outs[w] / "loss_trace.jsonl").read())
              for w in ("jax", "port"))
    assert ta["frame"] == tb["frame"] == SUBJECT
    assert len(tb["losses"]) == 16
    np.testing.assert_allclose(tb["losses"], ta["losses"], rtol=1e-5)
    # the texture stage, on the JAX app's views and fit
    same = tmp_path / "port_on_jax_fit"
    _texfit_on("port", scans, outs["jax"], same, _auto_uv(tmp_path))
    _assert_texfit_close(same / SUBJECT / "texfit", j / "texfit")


def test_uv_template_texfit_matches_jax(scans, full_runs, tmp_path):
    """``--smpl_uv_dir`` with a template OBJ (``make_uv_template``'s,
    written by the port): both apps' texture stage on the JAX app's views
    and fit."""
    extra = ["--smpl_uv_dir", str(scans / "smpl_uv")]
    for w in ("jax", "port"):
        _texfit_on(w, scans, full_runs["jax"], tmp_path / w, extra)
    _assert_texfit_close(tmp_path / "port" / SUBJECT / "texfit",
                         tmp_path / "jax" / SUBJECT / "texfit")


def test_texfit_rerun_reuses_cached_views_and_fit(scans, full_runs,
                                                  tmp_path, monkeypatch):
    """``--tasks texfit output`` after a full run: the views are re-read
    from ``images/`` and ``masks/`` (nothing is rendered), the fit is the
    written one, and the texture equals the first run's byte for byte."""
    out = tmp_path / "port"
    shutil.copytree(full_runs["port"], out)
    first = open(out / SUBJECT / "texfit" / "smpl.png", "rb").read()
    os.remove(out / SUBJECT / "texfit" / "smpl.png")
    from bodyfitting_torch.fitting import texture as texfit

    def no_render(*a, **k):
        raise AssertionError("the cached views were not used")

    monkeypatch.setattr(texfit, "render_scan_views", no_render)
    runner = _run("port", scans, out, _auto_uv(tmp_path),
                  tasks=("texfit", "output"))
    assert open(out / SUBJECT / "texfit" / "smpl.png", "rb").read() == first
    assert set(runner.timings[SUBJECT]) == {
        "prep", "smplify+smpld", "texfit", "output", "texfit/fit",
        "texfit/atlas+fill+inpaint", "texfit/writes", "texfit/render_compare"}
    # the cached views read back as the renders that were written
    data = runner.render_data(SUBJECT, str(scans / "scans" / SUBJECT /
                                           f"{SUBJECT}.obj"))
    for i in range(VIEWS):
        np.testing.assert_array_equal(
            data[2][i], _png(out / SUBJECT / "images" / ("%02d.png" % i)))
        np.testing.assert_array_equal(
            data[3][i], _png(out / SUBJECT / "masks" / ("%02d.png" % i)))


def test_info_dir_genders_match_jax(scans, tmp_path):
    """``--info_dir``'s CSV rows give the scans' genders in order, and
    each scan fits with its gender's model."""
    from bodyfitting_tpu.apps import renderpeople as japp

    root = tmp_path / "two"
    rng = np.random.default_rng(0)
    for s in ("subjectA", "subjectB"):
        _write_scan(root / "scans" / s, rng)
    csv_path = tmp_path / "info.csv"
    csv_path.write_text("subjectA,0\nsubjectB,1\n")
    for s in ("subjectA", "subjectB"):
        _write_jsons(str(tmp_path / "out"), subject=s)
    argv = _argv(root, tmp_path / "out", ["--info_dir", str(csv_path)],
                 tasks=("output",))
    runner = papp.Runner(papp.config_parser().parse_args(argv), device="cpu")
    ref = japp.Runner(japp.config_parser().parse_args(argv))
    assert runner.genders == ref.genders
    assert sorted(runner.genders) == ["female", "male"]
    runner.run()
    assert set(runner._models) == {"female", "male"}
    assert set(runner.timings) == {"subjectA", "subjectB"}


def test_render_compare_matches_jax(scans, tmp_path):
    from bodyfitting_tpu.fitting import texture as jtex
    from bodyfitting_torch.fitting import texture as ptex
    from bodyfitting_torch.io.obj import load_obj

    scan = load_obj(str(scans / "scans" / SUBJECT / f"{SUBJECT}.obj"),
                    load_texture=True)
    assert scan.texture is not None
    fuv = scan.uvs[scan.face_uvs]
    rng = np.random.default_rng(3)
    smpl = (scan.verts * 0.9, scan.faces, fuv,
            rng.uniform(size=(32, 32, 3)).astype(np.float32))
    scan_mesh = (scan.verts, scan.faces, fuv, scan.texture)
    got = ptex.render_compare(smpl, scan_mesh, str(tmp_path / "port"),
                              viewnum=5, imgsize=SIZE, device="cpu")
    ref = jtex.render_compare(smpl, scan_mesh, str(tmp_path / "jax"),
                              viewnum=5, imgsize=SIZE, write_video=False)
    assert len(got) == len(ref) == 5
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == (SIZE, 2 * SIZE, 3)
        _assert_within_one_level(a, np.asarray(b), f"view {i}")
        np.testing.assert_array_equal(
            _png(tmp_path / "port" / ("%04d.png" % i)), a)
    assert not any(f.endswith(".mp4") for f in os.listdir(tmp_path / "port"))


def test_app_cli_and_device(scans, tmp_path, monkeypatch):
    """Every flag of the JAX app's parser, and no run without a card
    unless the caller asks for the CPU."""
    from bodyfitting_tpu.apps import renderpeople as japp

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(papp.config_parser()) == flags(japp.config_parser())
    for a in japp.config_parser()._actions:
        b = next(x for x in papp.config_parser()._actions
                 if x.dest == a.dest)
        assert (a.default, a.nargs, a.type) == (b.default, b.nargs, b.type)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp.main(_argv(scans, tmp_path, []))
    assert papp.discover_scans(str(scans / "scans"))[0] == [SUBJECT]


def test_use_mask_fit_matches_jax(scans, tmp_path, monkeypatch):
    """``--use_mask``: the scan fit with the silhouette term on the full
    masks of the rendered views (the sampler with coverage, the contour
    match and its scatter on the card) beside the point-to-scan term,
    both apps from the same cached keypoints."""
    from bodyfitting_torch.losses import silhouette as sil

    calls = {}
    for name in ("bilinear_cov_grads", "contour_match_full",
                 "rows_scatter_add"):
        def counted(*a, _fn=getattr(sil, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(sil, name, counted)
    outs = {w: tmp_path / w for w in ("jax", "port")}
    for w, out in outs.items():
        _run(w, scans, out, ["--use_mask"], tasks=("smplify",))
    # the 5 steps after the gate (step 8 // 3) each sample the full masks
    # twice (with coverage, and the lookup) and match the contours once
    assert calls == {"bilinear_cov_grads": 10, "contour_match_full": 5,
                     "rows_scatter_add": 5}, calls
    a, b = (np.load(outs[w] / SUBJECT / "smplify" / "smpl_parameter.npy",
                    allow_pickle=True).item() for w in ("jax", "port"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
    ta, tb = (json.loads(open(outs[w] / "loss_trace.jsonl").read())
              for w in ("jax", "port"))
    assert len(tb["losses"]) == 8
    np.testing.assert_allclose(tb["losses"], ta["losses"], rtol=1e-5)
