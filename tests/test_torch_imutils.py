"""The port's SPIN crop helpers against the JAX package's (which call
OpenCV), on the CPU.

* ``get_transform``, ``transform``, the flips and ``uncrop`` (OpenCV's
  INTER_NEAREST resize): exactly equal.
* ``crop`` without rotation (OpenCV's float32 INTER_LINEAR resize, then
  the cast back to uint8): exactly equal.
* ``crop`` with rotation (OpenCV 5's ``warpAffine``, then the resize):
  the port's model of ``warpAffine`` reproduces OpenCV 5.0 here exactly
  (0 differing pixels on these crops); the test allows at most 1 % of the
  pixels to differ, by at most 1 level, because OpenCV picks its SIMD
  code by the CPU it runs on and the model's block width is its AVX2
  one.
* ``rot_aa`` (``cv2.Rodrigues`` there): 1e-12 absolute.
"""

import numpy as np
import pytest

from bodyfitting_tpu.utils import imutils as J
from bodyfitting_torch.utils import imutils as T

CROPS = [((160, 120), 1.0, (224, 224)), ((30, 200), 0.7, (224, 224)),
         ((160, 120), 1.3, (256, 192)), ((300, 20), 0.5, (224, 224)),
         ((161.7, 118.2), 0.83, (224, 224))]


def _images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    y, x = np.mgrid[0:240, 0:320]
    smooth = np.stack([(x * 0.8 + y * 0.3) % 256, (y * 0.9) % 256,
                       128 + 100 * np.sin(x / 20.0)], -1).astype(np.uint8)
    return {"noise": noise, "smooth": smooth, "grey": smooth[..., 1].copy()}


@pytest.mark.parametrize("kind", ["noise", "smooth", "grey"])
def test_crop_without_rotation_equals_jax(kind):
    img = _images()[kind]
    for center, scale, res in CROPS:
        got = T.crop(img, center, scale, res)
        want = J.crop(img, center, scale, res)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("rot", [30, -45, 10])
def test_rotated_crop_matches_jax(kind, rot):
    img = _images()[kind]
    for center, scale, res in CROPS[:3]:
        got = T.crop(img, center, scale, res, rot=rot)
        want = J.crop(img, center, scale, res, rot=rot)
        assert got.shape == want.shape
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(),
                                                         (d > 0).mean())


def test_uncrop_equals_jax():
    img = _images()["noise"]
    for center, scale, res in CROPS:
        c = J.crop(img, center, scale, res)
        np.testing.assert_array_equal(T.uncrop(c, center, scale, img.shape),
                                      J.uncrop(c, center, scale, img.shape))


def test_transforms_and_flips_equal_jax():
    rng = np.random.default_rng(1)
    for center, scale, res in CROPS:
        for rot in (0, 25):
            np.testing.assert_array_equal(
                T.get_transform(center, scale, res, rot),
                J.get_transform(center, scale, res, rot))
            for pt in ([1, 1], [57, 13], [223, 200]):
                for inv in (0, 1):
                    np.testing.assert_array_equal(
                        T.transform(pt, center, scale, res, inv, rot),
                        J.transform(pt, center, scale, res, inv, rot))
    img = _images()["noise"]
    np.testing.assert_array_equal(T.flip_img(img), J.flip_img(img))
    for n in (24, 49):
        kp = rng.normal(size=(n, 3))
        np.testing.assert_array_equal(T.flip_kp(kp), J.flip_kp(kp))
    pose = rng.normal(size=72)
    np.testing.assert_array_equal(T.flip_pose(pose), J.flip_pose(pose))
    np.testing.assert_array_equal(T.flip_pose(T.flip_pose(pose)), pose)
    assert T.SMPL_POSE_FLIP_PERM == J.SMPL_POSE_FLIP_PERM
    assert T.SPIN_JOINT_FLIP_PERM == J.SPIN_JOINT_FLIP_PERM


def test_rot_aa_matches_jax():
    rng = np.random.default_rng(2)
    for aa in list(rng.normal(size=(10, 3)).astype(np.float32)) + [
            np.zeros(3, np.float32)]:
        for rot in (0.0, 30.0, -170.0):
            got = T.rot_aa(aa, rot)
            want = J.rot_aa(aa, rot)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    aa = rng.normal(size=3)
    np.testing.assert_allclose(T.rot_aa(aa, 40.0), J.rot_aa(aa, 40.0),
                               rtol=0, atol=1e-12)


def test_warp_and_resizes_equal_opencv():
    cv2 = pytest.importorskip("cv2")
    from bodyfitting_torch.io.images import resize_linear_f32, resize_nearest

    rng = np.random.default_rng(3)
    for H, W, c in ((60, 60, 1), (50, 77, 3), (64, 64, 3)):
        img = (rng.integers(0, 256, (H, W, c))[..., :c].squeeze()
               .astype(np.float32))
        M = cv2.getRotationMatrix2D((W / 2, H / 2), 30, 1.0)
        np.testing.assert_allclose(T.rotation_matrix_2d((W / 2, H / 2), 30),
                                   M, rtol=0, atol=1e-12)
        got = T.warp_affine_linear(img, M, (W, H))
        want = cv2.warpAffine(img, M, (W, H))
        assert (got != want).mean() <= 0.01
        for oh, ow in ((224, 224), (11, 91), (H, W), (H // 2, W // 2)):
            np.testing.assert_array_equal(
                resize_linear_f32(img, ow, oh),
                cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))
            np.testing.assert_array_equal(
                resize_nearest(img, ow, oh),
                cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST))
