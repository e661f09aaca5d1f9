"""The port's OpenPose detector against the JAX package's on the same
numpy inputs.

* The three nets on the same seeded weights (He-normal kernels drawn with
  numpy, carried across by ``convert.openpose_state_dict_from_flax``), at
  a 64x64 and a 96x80 input: within 1e-4 of the largest output magnitude
  (measured 2.8e-6 to 4.9e-6: float32 convolutions summed in other
  orders through ~40 layers).
* ``load_*_net`` from seeded ``.pth`` files in the released layout, flat
  and ``model0.``-prefixed: both packages read the same weights, bit for
  bit; the key check names the file and the missing or mis-shaped key.
* The detector's resizes against ``cv2.resize``: the float maps to 1e-6
  of their scale (measured <= 8e-7); the uint8 input at ``fx`` with
  OpenCV's output shape and its values equal but at a share of the
  pixels below 2e-5, where they are one level off (measured 5.8e-6 over
  the shapes below; OpenCV 5.0).
* ``_multiscale_maps`` at ``boxsize = H``, one scale (both feed the net
  the same pixels): within 1e-4 of the maps' scale (measured 4e-6).
* The smoothing equals ``scipy.ndimage.gaussian_filter`` bit for bit;
  ``find_peaks``, ``assemble_people`` (two synthetic people, the JAX
  tests' fields), ``hand_boxes``, ``face_box``, ``person_to_body25`` and
  ``_crop_peaks_with_scores`` equal the JAX functions exactly, on the
  host and on the batched device path (here with CPU tensors).
* ``detect_to_json`` with the JAX tests' stub body and fake face net:
  the same JSON arrays.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyfitting_tpu.models import openpose as jop
from bodyfitting_tpu.models import openpose_infer as jopi
from bodyfitting_torch.convert import openpose_state_dict_from_flax
from bodyfitting_torch.io.images import resize_maps_cubic, resize_u8_cubic_fx
from bodyfitting_torch.models import openpose as pop
from bodyfitting_torch.models import openpose_infer as popi

KINDS = {"body": (jop.BodyPoseNet, pop.load_body_net),
         "hand": (jop.HandPoseNet, pop.load_hand_net),
         "face": (jop.FacePoseNet, pop.load_face_net)}


def _flax_variables(kind, seed=0):
    """He-normal kernels and small biases for the Flax ``kind`` net, drawn
    with numpy from the shapes (no compile of ``init``)."""
    shapes = jax.eval_shape(KINDS[kind][0]().init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            x = rng.normal(size=s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        else:
            x = rng.uniform(-0.05, 0.05, size=s.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_net(kind, variables):
    net = KINDS[kind][1](None, device="cpu")
    sd = openpose_state_dict_from_flax(jax.tree.map(np.asarray, variables))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return net


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.fixture(scope="module")
def nets():
    """Per kind: the Flax model's jitted apply on its seeded variables and
    the port's net on the same weights."""
    out = {}
    for kind in KINDS:
        v = _flax_variables(kind, seed=len(out))
        apply = jax.jit(KINDS[kind][0]().apply)
        out[kind] = ((lambda x, a=apply, v=v: a(v, x)), _port_net(kind, v))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_nets_match_flax_on_converted_weights(nets, kind):
    japply, net = nets[kind]
    rng = np.random.default_rng(1)
    for h, w in ((64, 64), (96, 80)):
        x = rng.uniform(-0.5, 0.5, size=(2, h, w, 3)).astype(np.float32)
        ref = _as_tuple(japply(jnp.asarray(x)))
        with torch.no_grad():
            got = _as_tuple(net(torch.from_numpy(x).permute(0, 3, 1, 2)))
        assert len(ref) == len(got) == len(net.n_out)
        for r, g, n in zip(ref, got, net.n_out):
            r = np.asarray(r)
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == r.shape == (2, h // 8, w // 8, n)
            scale = np.abs(r).max()
            assert scale > 0
            assert np.abs(g - r).max() <= 1e-4 * scale


@pytest.mark.parametrize("hw", [(96, 80), (90, 75)], ids=["96x80", "padded"])
def test_multiscale_maps_match_jax(nets, hw):
    """At ``boxsize = H`` and one scale both packages feed the net the same
    pixels; 90x75 is padded to 96x80 with the pad value first."""
    japply, net = nets["body"]
    img = np.random.default_rng(2).integers(0, 256, hw + (3,)).astype(
        np.uint8)
    ref = jopi._multiscale_maps(japply, img, [38, 19], boxsize=hw[0],
                                scales=(1.0,))
    got = popi._multiscale_maps(net, img, [38, 19], boxsize=hw[0],
                                scales=(1.0,), device="cpu")
    for r, g in zip(ref, got):
        assert g.shape == r.shape == hw + (r.shape[2],)
        assert g.dtype == np.float32
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def _write_pth(path, kind, prefix, seed=3):
    sd = pop.seeded_state_dict(kind, seed)
    torch.save({prefix + k: v for k, v in sd.items()}, str(path))
    return sd


@pytest.mark.parametrize("kind,prefix", [("body", ""), ("hand", "model0."),
                                         ("face", "")],
                         ids=["body_flat", "hand_prefixed", "face_flat"])
def test_both_packages_load_the_same_pth(tmp_path, kind, prefix):
    path = tmp_path / f"{kind}.pth"
    sd = _write_pth(path, kind, prefix)
    net = KINDS[kind][1](str(path), device="cpu")
    got = net.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    _, jvars = getattr(jop, f"load_{kind}_net")(str(path))
    jsd = openpose_state_dict_from_flax(jax.tree.map(np.asarray, jvars))
    assert set(jsd) == set(sd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_load_refuses_mismatched_checkpoints(tmp_path):
    sd = pop.seeded_state_dict("hand", 0)
    bad = dict(sd)
    del bad["Mconv3_stage4.weight"]
    path = tmp_path / "missing.pth"
    torch.save(bad, str(path))
    with pytest.raises(ValueError, match="missing.pth") as e:
        pop.load_hand_net(str(path), device="cpu")
    assert "missing  Mconv3_stage4.weight" in str(e.value)
    bad = dict(sd)
    bad["conv1_1.weight"] = torch.zeros(64, 3, 5, 5)
    path = tmp_path / "shape.pth"
    torch.save(bad, str(path))
    with pytest.raises(ValueError, match="shape.pth") as e:
        pop.load_hand_net(str(path), device="cpu")
    assert "shape    conv1_1.weight  expected (64, 3, 3, 3)" in str(e.value)


@pytest.mark.parametrize("shape,kw", [
    ((46, 46, 38), dict(factor=8)),
    ((92, 92, 19), dict(factor=8)),
    ((184, 184, 19), dict(size=(512, 512))),
    ((552, 552, 19), dict(size=(512, 512))),
    ((367, 370, 19), dict(size=(512, 512))),
], ids=["x8_38ch", "x8_19ch", "184_to_512", "552_to_512", "367x370_to_512"])
def test_float_map_resize_matches_cv2(shape, kw):
    m = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    if "factor" in kw:
        ref = cv2.resize(m, (0, 0), fx=kw["factor"], fy=kw["factor"],
                         interpolation=cv2.INTER_CUBIC)
    else:
        ref = cv2.resize(m, kw["size"][::-1], interpolation=cv2.INTER_CUBIC)
    got = resize_maps_cubic(torch.from_numpy(m).permute(2, 0, 1)[None],
                            **kw)[0].permute(1, 2, 0).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_u8_input_resize_matches_cv2():
    """The shapes at ``fx`` are OpenCV's (``round(src * fx)``, positions by
    ``1 / fx``: the 96x80 image's 153 columns); the values equal but at a
    share of the pixels below 2e-5, each one level off."""
    rng = np.random.default_rng(5)
    cases = [((512, 512, 3), s * 368 / 512) for s in (0.5, 1.0, 1.5, 2.0)]
    cases += [((96, 80, 3), s * 368 / 96) for s in (0.5, 1.0)]
    cases += [((137, 137, 3), 1.5 * 368 / 137), ((61, 61, 3), 2 * 368 / 61),
              ((23, 23, 3), 368 / 23), ((512, 512, 3), 1.0)]
    off = total = 0
    for shape, fx in cases:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        ref = cv2.resize(img, (0, 0), fx=fx, fy=fx,
                         interpolation=cv2.INTER_CUBIC)
        got = resize_u8_cubic_fx(torch.from_numpy(img)[None], fx)[0].numpy()
        assert got.shape == ref.shape, (shape, fx)
        assert np.abs(got.astype(int) - ref).max() <= 1
        off += int((got != ref).sum())
        total += ref.size
    assert cv2.resize(np.zeros((96, 80, 3), np.uint8), (0, 0), fx=1.9167,
                      fy=1.9167).shape[1] == 153
    assert off / total < 2e-5


def test_gaussian_smooth_equals_scipy():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(6)
    maps = [rng.normal(size=s).astype(np.float32)
            for s in ((64, 64), (20, 23), (13, 40), (5, 7), (128, 96))]
    for m in maps:
        got = popi.gaussian_smooth(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, gaussian_filter(m, sigma=3))
    stack = np.stack([rng.normal(size=(2, 3, 33, 21)).astype(np.float32)])[0]
    got = popi.gaussian_smooth(torch.from_numpy(stack)).numpy()
    for idx in np.ndindex(2, 3):
        np.testing.assert_array_equal(got[idx],
                                      gaussian_filter(stack[idx], sigma=3))


# --- the JAX tests' synthetic fields (tests/test_openpose.py) -------------


def _synthetic_fields(people, H=128, W=128):
    """Heatmaps + PAFs for a list of 18-part skeletons."""
    heat = np.zeros((H, W, 19), np.float32)
    paf = np.zeros((H, W, 38), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for kp in people:
        for part in range(18):
            x, y = kp[part]
            heat[:, :, part] += np.exp(
                -((xx - x) ** 2 + (yy - y) ** 2) / (2 * 2.0 ** 2))
        for limb, midx in zip(jopi.LIMB_SEQ, jopi.MAP_IDX):
            a = np.array(kp[limb[0] - 1], np.float64)
            b = np.array(kp[limb[1] - 1], np.float64)
            vec = b - a
            norm = np.linalg.norm(vec)
            if norm < 1e-6:
                continue
            vecn = vec / norm
            ap = np.stack([xx - a[0], yy - a[1]], -1)
            t = (ap @ vecn) / norm
            perp = np.abs(ap @ np.array([-vecn[1], vecn[0]]))
            band = (t >= -0.05) & (t <= 1.05) & (perp < 4)
            ch = [midx[0] - 19, midx[1] - 19]
            paf[:, :, ch[0]][band] = vecn[0]
            paf[:, :, ch[1]][band] = vecn[1]
    return heat, paf


def _skeleton(cx, cy, s=1.0):
    """A plausible 18-part stick figure centred at (cx, cy)."""
    base = {
        0: (0, -42), 1: (0, -30), 2: (-12, -30), 3: (-16, -12),
        4: (-18, 4), 5: (12, -30), 6: (16, -12), 7: (18, 4),
        8: (-8, 0), 9: (-9, 20), 10: (-10, 40), 11: (8, 0),
        12: (9, 20), 13: (10, 40), 14: (-4, -45), 15: (4, -45),
        16: (-9, -43), 17: (9, -43),
    }
    return {k: (cx + s * dx, cy + s * dy) for k, (dx, dy) in base.items()}


def _fields():
    """Two people, and the same maps with seeded noise (more peaks, more
    candidate limbs and drafts)."""
    heat, paf = _synthetic_fields([_skeleton(40, 60), _skeleton(90, 60)])
    rng = np.random.default_rng(7)
    noisy = (heat + 0.3 * rng.random(heat.shape).astype(np.float32),
             paf + 0.2 * rng.normal(size=paf.shape).astype(np.float32))
    return [(heat, paf), noisy]


def _same_people(a, b):
    (ca, sa), (cb, sb) = a, b
    assert ca.dtype == cb.dtype and sa.dtype == sb.dtype
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(sa, sb)


def test_peaks_and_assembly_equal_jax():
    fields = _fields()
    for thre in (0.3, 0.1):
        for heat, paf in fields:
            ref_peaks = jopi.find_peaks(heat, thre1=thre)
            assert popi.find_peaks(heat, thre1=thre) == ref_peaks
            ref = jopi.assemble_people(ref_peaks, paf, img_h=128)
            _same_people(popi.assemble_people(ref_peaks, paf, img_h=128), ref)
        # the batched path: every view at once, from tensors
        heat_t = torch.from_numpy(np.stack([h for h, _ in fields])).permute(
            0, 3, 1, 2).contiguous()
        paf_t = torch.from_numpy(np.stack([p for _, p in fields])).permute(
            0, 3, 1, 2).contiguous()
        peaks = popi.find_peaks_batch(heat_t, thre1=thre, view_chunk=1)
        people = popi.assemble_people_batch(peaks, paf_t, 128)
        for (heat, paf), pk, pp in zip(fields, peaks, people):
            ref_peaks = jopi.find_peaks(heat, thre1=thre)
            assert pk == ref_peaks
            _same_people(pp, jopi.assemble_people(ref_peaks, paf, img_h=128))
    # the clean fields give the two people of the JAX test
    _, subset = people[0]
    assert len(subset) == 2 and (subset[:, -1] >= 16).all()


def test_sample_positions_equal_linspace():
    rng = np.random.default_rng(8)
    pa = [(int(x), int(y), 0.5, i) for i, (x, y) in
          enumerate(rng.integers(0, 512, (6, 2)))] + [(7, 7, 0.5, 6)]
    pb = [(int(x), int(y), 0.5, i) for i, (x, y) in
          enumerate(rng.integers(0, 512, (5, 2)))] + [(7, 7, 0.5, 5)]
    xs, ys = popi._sample_positions(pa, pb, 100)
    p = 0
    for a in pa:
        for b in pb:
            np.testing.assert_array_equal(
                xs[p], np.round(np.linspace(a[0], b[0], 100)).astype(int))
            np.testing.assert_array_equal(
                ys[p], np.round(np.linspace(a[1], b[1], 100)).astype(int))
            p += 1


def test_boxes_and_body25_equal_jax():
    heat, paf = _synthetic_fields([_skeleton(64, 70, s=1.2),
                                   _skeleton(150, 80, s=1.0)], H=160, W=220)
    peaks = jopi.find_peaks(heat, thre1=0.3)
    candidate, subset = jopi.assemble_people(peaks, paf, img_h=160)
    assert len(subset) == 2
    for shape in ((160, 220), (100, 120)):
        assert popi.hand_boxes(candidate, subset, shape) == \
            jopi.hand_boxes(candidate, subset, shape)
        for row in subset:
            assert popi.face_box(candidate, row, shape) == \
                jopi.face_box(candidate, row, shape)
    for row in subset:
        b = popi.person_to_body25(candidate, row)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, jopi.person_to_body25(candidate,
                                                                row))
    # missing parts: no head, one arm, no hips
    row = subset[0].copy()
    row[[0, 1, 14, 15, 16, 17, 5, 8, 11]] = -1
    assert popi.face_box(candidate, row, (160, 220)) is None is \
        jopi.face_box(candidate, row, (160, 220))
    assert popi.hand_boxes(candidate, row[None], (160, 220)) == \
        jopi.hand_boxes(candidate, row[None], (160, 220))
    np.testing.assert_array_equal(popi.person_to_body25(candidate, row),
                                  jopi.person_to_body25(candidate, row))


def test_crop_peaks_equal_jax():
    rng = np.random.default_rng(9)
    heat = np.zeros((40, 44, 22), np.float32)
    ys, xs = np.mgrid[0:40, 0:44]
    for k in range(21):
        for _ in range(k % 3):                   # 0, 1 or 2 blobs a part
            cy, cx = rng.uniform(0, 40), rng.uniform(0, 44)
            heat[:, :, k] += rng.uniform(0.05, 1.0) * np.exp(
                -((ys - cy) ** 2 + (xs - cx) ** 2) / rng.uniform(2, 20))
    heat += 0.02 * rng.random(heat.shape).astype(np.float32)
    for thre in (0.05, 0.2):
        ref = jopi._crop_peaks_with_scores(heat, 21, thre)
        for got in (popi._crop_peaks_with_scores(heat, 21, thre),
                    popi._crop_peaks_device(
                        torch.from_numpy(heat).permute(2, 0, 1), 21, thre)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
        assert (ref[:, 2] == 0).any() and (ref[:, 2] > 0).any()


def _face_bumps(h, w):
    """The JAX test's fake face maps: part k peaks on a grid, score ~0.7."""
    hm = np.zeros((h, w, 71), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for k in range(70):
        cy, cx = 2 + (k % 5), 2 + (k // 5 % 5)
        hm[:, :, k] = 0.7 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 4.0)
    return hm


def test_detect_to_json_equals_jax(tmp_path):
    """The JAX tests' stub body and fake face net through both packages'
    ``detect_to_json``: the same JSON arrays (to 1e-6)."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(2):
        cv2.imwrite(str(img_dir / f"{i:02d}.png"),
                    np.full((256, 256, 3), 40 * i, np.uint8))
    heat, paf = _synthetic_fields([_skeleton(128, 140, s=2.0)], H=256, W=256)

    def stub(opi):
        class StubBody:
            def __call__(self, img):
                peaks = opi.find_peaks(heat, thre1=0.3)
                return opi.assemble_people(peaks, paf, img_h=256)
        return StubBody()

    jface = jopi.FaceDetector(scales=(0.5,))
    jface._apply = lambda x: jnp.asarray(
        _face_bumps(x.shape[1] // 8, x.shape[2] // 8)[None])
    pface = popi.FaceDetector(scales=(0.5,), device="cpu")
    pface.net = lambda x: torch.from_numpy(_face_bumps(
        x.shape[2] // 8, x.shape[3] // 8)).permute(2, 0, 1)[None]
    jopi.detect_to_json(str(img_dir), str(tmp_path / "jax"), stub(jopi),
                        hand=None, hand_face=True, face=jface)
    popi.detect_to_json(str(img_dir), str(tmp_path / "port"), stub(popi),
                        hand=None, hand_face=True, face=pface)
    for i in range(2):
        name = f"{i:02d}_keypoints.json"
        ref = json.load(open(tmp_path / "jax" / name))
        got = json.load(open(tmp_path / "port" / name))
        assert got["version"] == ref["version"] == 1.3
        assert len(got["people"]) == len(ref["people"]) == 1
        for key, n in (("pose_keypoints_2d", 75), ("face_keypoints_2d", 210)):
            a = np.asarray(ref["people"][0][key])
            b = np.asarray(got["people"][0][key])
            assert a.shape == b.shape == (n,)
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        assert (np.asarray(got["people"][0]["face_keypoints_2d"])[2::3]
                > 0).sum() >= 60
