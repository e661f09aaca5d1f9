"""The port's host I/O against OpenCV and the JAX package's readers and
writers: PNG decoding and encoding, OpenCV's INTER_LINEAR resize, the
square crop, OBJ bytes, the parameter, annotation and OpenPose files,
the loss trace and ``load_model`` on synthetic assets.

Tolerances: every comparison is exact (equal bytes, equal arrays)
except ``resize_cubic`` (within one level of ``cv2.resize(INTER_CUBIC)``:
the port rounds the fixed-point sum once, OpenCV's vector pass in
float32) and the body model's float arrays (f32 of the same f64 data).
"""

import json
import pickle
import struct
import sys
import types
import zlib

import cv2
import numpy as np
import pytest

from bodyfitting_tpu.io import cameras as jcam
from bodyfitting_tpu.io import images as jimg
from bodyfitting_tpu.io import obj as jobj
from bodyfitting_tpu.io import openpose as jop
from bodyfitting_tpu.io import params as jparams
from bodyfitting_tpu.models import body_model as jbm
from bodyfitting_tpu.utils import observability as jobs
from bodyfitting_torch.io import cameras as pcam
from bodyfitting_torch.io import images as pimg
from bodyfitting_torch.io import obj as pobj
from bodyfitting_torch.io import openpose as pop
from bodyfitting_torch.io import params as pparams
from bodyfitting_torch.io import png
from bodyfitting_torch.models import body_model as pbm
from bodyfitting_torch.utils import observability as pobs


def _rich_image(h=96, w=128, seed=0):
    """Smooth, noisy, ramp and flat bands: rows on which libpng's
    adaptive choice lands on every filter type."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 128 + 60 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0)
    bands = [smooth, rng.integers(0, 256, (h, w)), (xx * 2 + yy) % 256,
             np.zeros((h, w)), (xx * 3) % 256]
    return np.concatenate(bands, 0).astype(np.uint8)


def _filter_types(data: bytes):
    """The filter byte of every row of a PNG."""
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, _, colour = hdr[:4]
    stride = w * {0: 1, 4: 2, 2: 3, 6: 4}[colour]
    raw = zlib.decompress(b"".join(idat))
    return {raw[i * (stride + 1)] for i in range(h)}


def _make_png(img, filter_type, colour=None, depth=8, interlace=0):
    """A PNG whose every row uses ``filter_type``, written from the
    specification (independent of the port's encoder)."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, ch = img.shape
    bpp = ch
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if filter_type == 0:
            f = cur
        elif filter_type == 1:
            f = cur - left
        elif filter_type == 2:
            f = cur - prev
        elif filter_type == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(bytes([filter_type]) + (f % 256).astype(np.uint8).tobytes())
    if colour is None:
        colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_on_opencv_files_with_every_filter(tmp_path, channels):
    g = _rich_image()
    img = g if channels == 1 else np.stack(
        [g, np.roll(g, 5, 1), 255 - g, np.roll(g, 9, 0)][:channels], -1)
    seen = set()
    for flag in (cv2.IMWRITE_PNG_ALL_FILTERS, cv2.IMWRITE_PNG_FILTER_NONE,
                 cv2.IMWRITE_PNG_FILTER_SUB, cv2.IMWRITE_PNG_FILTER_UP,
                 cv2.IMWRITE_PNG_FILTER_AVG, cv2.IMWRITE_PNG_FILTER_PAETH):
        path = str(tmp_path / f"img_{flag}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
        seen |= _filter_types(open(path, "rb").read())
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(pimg.imread_checked(
            path, pimg.IMREAD_UNCHANGED), ref)
        np.testing.assert_array_equal(pimg.imread_checked(path),
                                      cv2.imread(path, cv2.IMREAD_COLOR))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_on_hand_made_files(filter_type, channels):
    rng = np.random.default_rng(filter_type * 10 + channels)
    img = rng.integers(0, 256, (13, 17, channels)).astype(np.uint8)
    img[4:9] = 200                                     # flat rows too
    got = png.decode_png(_make_png(img, filter_type))
    np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)


def test_png_writer_round_trips_and_opencv_reads_it(tmp_path):
    g = _rich_image(40, 50)
    for img in (g, np.stack([g, 255 - g], -1),
                np.stack([g, g // 2, 255 - g], -1),
                np.stack([g, g // 2, 255 - g, np.roll(g, 3, 0)], -1)):
        path = str(tmp_path / "rt.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            pimg.imread_checked(path, pimg.IMREAD_UNCHANGED), ref)
    # the grey+alpha file reads as cv2 does: BGRA with B = G = R = grey
    assert ref.shape[-1] == 4


def test_png_refuses_what_it_does_not_decode(tmp_path):
    img = np.zeros((4, 5, 1), np.uint8)
    cases = {
        "16-bit": _make_png(np.zeros((4, 10, 1), np.uint8), 0, colour=0,
                            depth=16),
        "palette": _make_png(img, 0, colour=3),
        "interlaced": _make_png(img, 0, interlace=1),
    }
    for what, data in cases.items():
        path = str(tmp_path / f"{what}.png")
        open(path, "wb").write(data)
        with pytest.raises(ValueError, match=f"{what}.png"):
            png.read_png(path)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        pimg.imread_checked(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="photo.jpg"):
        pimg.imread_checked(jpg)


@pytest.mark.parametrize("seed", range(4))
def test_crop_and_resize_equals_opencv(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(80, 400, size=2)
    mask = np.zeros((h, w), np.uint8)
    y0, x0 = rng.integers(5, h // 3), rng.integers(5, w // 3)
    mask[y0:y0 + h // 2, x0:x0 + w // 3] = 255
    mask[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 255
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    bbox = pimg.mask_square_bbox(mask)
    assert bbox == jimg.mask_square_bbox(mask)
    for size in (64, 200, 512):
        for a in (mask, img, pimg.apply_mask(img, mask)):
            np.testing.assert_array_equal(
                pimg.crop_and_resize(a, bbox, size),
                jimg.crop_and_resize(a, bbox, size))
        K = np.array([[500.0, 0, w / 2], [0, 510.0, h / 2], [0, 0, 1]])
        np.testing.assert_array_equal(pimg.adjust_K_for_crop(K, bbox, size),
                                      jimg.adjust_K_for_crop(K, bbox, size))
    # an exact halving (OpenCV's INTER_AREA fast path) and a same-size copy
    for out in ((w // 2 * 2, h // 2 * 2), ):
        even = img[:out[1], :out[0]]
        np.testing.assert_array_equal(
            pimg.resize_linear(even, out[0] // 2, out[1] // 2),
            cv2.resize(even, (out[0] // 2, out[1] // 2),
                       interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(pimg.resize_linear(img, w, h), img)
    kp = np.concatenate([rng.uniform(0, 300, (25, 2)),
                         rng.uniform(0, 1, (25, 1))], 1)
    for a, b in zip(pimg.bbox_from_keypoints(kp),
                    jimg.bbox_from_keypoints(kp)):
        np.testing.assert_array_equal(a, b)
    cub = pimg.resize_cubic(img, 224, 224).astype(int)
    ref = cv2.resize(img, (224, 224), interpolation=cv2.INTER_CUBIC)
    assert np.abs(cub - ref).max() <= 1


def test_save_obj_is_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(500, 3)) * 0.5).astype(np.float32)
    v[0] = [-0.0, 1e-5, -0.00005]
    v[1] = [0.00005, 123.45675, -7.0]
    f = rng.integers(0, 500, (900, 3)).astype(np.int32)
    jobj.save_obj(str(tmp_path / "a.obj"), v, f, use_native=False)
    pobj.save_obj(str(tmp_path / "b.obj"), v, f)
    assert open(tmp_path / "a.obj", "rb").read() == \
        open(tmp_path / "b.obj", "rb").read()


def test_params_annots_and_openpose_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    result = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("vertices", (30, 3)), ("joints", (49, 3)), ("pose", (69,)),
        ("betas", (10,)), ("global_orient", (3,)), ("global_transl", (3,)),
        ("scale", (1,)), ("full_pose", (72,)))}
    faces = rng.integers(0, 30, (40, 3))
    disp = rng.normal(size=(30, 3)).astype(np.float32)
    for pkg, d in ((pparams, tmp_path / "p"), (jparams, tmp_path / "j")):
        pkg.save_fit_outputs(str(d), "smpl", result, faces, displacement=disp)
    a = jparams.load_params(str(tmp_path / "p" / "smpl_parameter.npy"))
    b = pparams.load_params(str(tmp_path / "j" / "smpl_parameter.npy"))
    assert set(a) == set(b) == set(jparams.PARAM_KEYS)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    for name in ("smpl.obj", "smpl+d.obj"):
        assert open(tmp_path / "p" / name, "rb").read() == \
            open(tmp_path / "j" / name, "rb").read()

    Ks = rng.normal(size=(6, 3, 3)).astype(np.float32)
    RTs = rng.normal(size=(6, 3, 4)).astype(np.float32)
    pcam.save_annots(str(tmp_path / "pa.npy"), Ks, RTs)
    jcam.save_annots(str(tmp_path / "ja.npy"), Ks, RTs)
    for x, y in zip(jcam.load_annots(str(tmp_path / "pa.npy")),
                    pcam.load_annots(str(tmp_path / "ja.npy"))):
        np.testing.assert_array_equal(x, y)
    assert pcam.genebody_views("wuwenyan") == jcam.genebody_views("wuwenyan")

    opdir = tmp_path / "openpose"
    opdir.mkdir()
    for v in range(3):
        people = []
        for p in range(2):
            people.append({
                f"{k}_keypoints_2d": rng.uniform(0, 100, size=n * 3).tolist()
                for k, n in (("pose", 25), ("hand_left", 21),
                             ("hand_right", 21), ("face", 70))})
        people[1]["hand_left_keypoints_2d"] = [0.0] * 63   # zero confidence
        doc = {"people": people if v != 1 else []}
        json.dump(doc, open(opdir / f"{v:02d}_keypoints.json", "w"))
    got, ref = pop.load_openpose_dir(str(opdir)), jop.load_openpose_dir(
        str(opdir))
    assert [g is None for g in got] == [r is None for r in ref] == [
        False, True, False]
    for g, r in zip(got, ref):
        if r is not None:
            assert set(g) == set(r)
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
    path = str(opdir / "00_keypoints.json")
    allp = pop.load_openpose(path, only_one=False)
    assert len(allp) == len(jop.load_openpose(path, only_one=False)) == 2


def test_loss_trace_and_stage_timer_match(tmp_path):
    losses = np.linspace(5.0, 1.0, 7).astype(np.float32)
    for pkg, name in ((pobs, "p.jsonl"), (jobs, "j.jsonl")):
        tr = pkg.LossTrace(str(tmp_path / name))
        tr.record(3, losses, terms={"kp": np.array([1.5, 0.5])}, every=2)
        tr.record(4, losses[:3])
        tr.to_csv()
    assert open(tmp_path / "p.jsonl").read() == open(tmp_path / "j.jsonl").read()
    assert open(tmp_path / "p.csv").read() == open(tmp_path / "j.csv").read()
    timer = pobs.StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("a"):
        pass
    timer.dump(str(tmp_path / "t" / "timing.json"))
    said = []
    with pobs.timed("stage x", log=said.append):
        pass
    assert said and said[0].startswith("[timing] stage x: ")
    s = json.load(open(tmp_path / "t" / "timing.json"))
    assert s["a"]["calls"] == 2 and set(s["a"]) == {"total_s", "calls",
                                                    "mean_s"}


class _FakeCh:
    """Stands in for a chumpy array in a pickled SMPL asset."""

    def __init__(self, x):
        self.x = x


def _asset(model_type, V=120, seed=0, legacy=False):
    rng = np.random.default_rng(seed)
    J = {"smpl": 24, "smplx": 55}[model_type]
    S = (20 if legacy else 400) if model_type == "smplx" else 10
    d = {
        "v_template": rng.normal(size=(V, 3)),
        "shapedirs": rng.normal(size=(V, 3, S)),
        "posedirs": rng.normal(size=(V, 3, (J - 1) * 9)),
        "J_regressor": rng.random((J, V)),
        "weights": rng.random((V, J)),
        "f": rng.integers(0, V, (2 * V, 3)).astype(np.uint32),
        "kintree_table": np.stack([
            np.concatenate([[2 ** 32 - 1], rng.integers(0, np.arange(1, J))]),
            np.arange(J)]).astype(np.int64),
    }
    if model_type == "smplx":
        d.update({
            "hands_componentsl": rng.normal(size=(45, 45)),
            "hands_componentsr": rng.normal(size=(45, 45)),
            "hands_meanl": rng.normal(size=45),
            "hands_meanr": rng.normal(size=45),
            "lmk_faces_idx": rng.integers(0, 2 * V, 51),
            "lmk_bary_coords": rng.random((51, 3)),
            "dynamic_lmk_faces_idx": rng.integers(0, 2 * V, (79, 17)),
            "dynamic_lmk_bary_coords": rng.random((79, 17, 3)),
        })
    return d


def _compare_models(pm, jm):
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights", "faces", "expr_dirs", "hand_components_l",
              "hand_mean_r", "lmk_faces_idx", "lmk_bary_coords",
              "dyn_lmk_faces_idx", "selector_ids", "joint_mapper",
              "kid_shape_dir", "extra_joint_regressor"):
        a, b = getattr(pm, f), getattr(jm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("model_type", "parents", "neck_chain", "num_betas",
              "num_expressions", "use_face_contour"):
        assert getattr(pm, f) == getattr(jm, f), f


@pytest.mark.parametrize("legacy", [False, True])
def test_load_model_smplx_npz_matches_jax(tmp_path, legacy):
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    np.savez(path, **_asset("smplx", legacy=legacy))
    _compare_models(pbm.load_model(path, device="cpu"), jbm.load_model(path))


def test_load_model_smpl_pkl_without_chumpy_matches_jax(tmp_path):
    """A pickled SMPL asset whose arrays are chumpy objects, with an
    extra joint regressor and a kid template."""
    mod = types.ModuleType("chumpy.ch")
    mod.Ch = _FakeCh
    _FakeCh.__module__ = "chumpy.ch"
    _FakeCh.__qualname__ = "Ch"
    sys.modules["chumpy"] = types.ModuleType("chumpy")
    sys.modules["chumpy.ch"] = mod
    try:
        d = _asset("smpl", V=6890 // 20)
        d["shapedirs"] = _FakeCh(d["shapedirs"])
        d["posedirs"] = _FakeCh(d["posedirs"])
        path = str(tmp_path / "SMPL_NEUTRAL.pkl")
        with open(path, "wb") as f:
            pickle.dump(d, f, protocol=2)
        kid = str(tmp_path / "kid.pkl")
        with open(kid, "wb") as f:
            pickle.dump(np.random.default_rng(5).normal(size=(344, 3)), f)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]
        _FakeCh.__module__ = __name__
        _FakeCh.__qualname__ = "_FakeCh"
    extra = str(tmp_path / "extra.npy")
    np.save(extra, np.random.default_rng(6).random((9, 344)))
    kw = dict(extra_joint_regressor_path=extra, kid_template_path=kid)
    pm = pbm.load_model(path, device="cpu", **kw)
    _compare_models(pm, jbm.load_model(path, **kw))
    assert pm.model_type == "smpl" and pm.num_betas == 11
