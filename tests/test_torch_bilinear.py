"""The sampler's image types on the CPU: the plain ``bilinear_cov_grads``
on bit masks against float32 images, the silhouette loss on the bit-mask
crops that fits sample against the f32 crops, the once-a-fit copy's
check, and the kernel's launch geometry as ``csrc/bilinear.cu`` states
it.

Tolerances: none.  A mask bit converts to float exactly, so on a 0/1
image the types give the same bits, in the loss and its gradient too.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.losses import silhouette as tsil
from bodyfitting_torch.ops import kernels as K
from bodyfitting_torch.ops.kernels import _build, bilinear
from chip_smoke import BILINEAR_MODES, bilinear_edge_cases


@pytest.mark.parametrize("mode", BILINEAR_MODES,
                         ids=["stay-inside", "lookup", "full-mask"])
@pytest.mark.parametrize("case", list(bilinear_edge_cases()))
def test_plain_bit_mask_f64_points_equal_f64_image_bitwise(case, mode):
    """f64 points (the f64 fits) on a bit mask: the taps take the points'
    type, so the result is the f64 image's; with coverage the bit mask is
    refused, as it is on the card."""
    img, xy = (torch.from_numpy(a) for a in bilinear_edge_cases()[case])
    bits = K.pack_bits(img)
    if mode["with_cov"]:
        with pytest.raises(ValueError, match="without coverage"):
            K.bilinear_cov_grads(bits, xy.double(), **mode)
        return
    got64 = K.bilinear_cov_grads(bits, xy.double(), **mode)
    ref64 = K.bilinear_cov_grads(img.double(), xy.double(), **mode)
    assert got64.dtype == torch.float64 and torch.equal(got64, ref64)


@pytest.mark.parametrize("mode", BILINEAR_MODES,
                         ids=["stay-inside", "lookup", "full-mask"])
@pytest.mark.parametrize("case", list(bilinear_edge_cases()))
def test_plain_bit_mask_equals_f32_bitwise(case, mode):
    """A bit mask samples as the f32 image zero-padded to a multiple of 32
    columns, which without coverage is the f32 image itself; with
    coverage (which would count the padding) it is refused."""
    img, xy = (torch.from_numpy(a) for a in bilinear_edge_cases()[case])
    bits = K.pack_bits(img)
    H, W = img.shape[1:]
    assert bits.dtype == torch.int32 and bits.shape[2] == -(-W // 32)
    padded = torch.nn.functional.pad(img, (0, 32 * bits.shape[2] - W))
    assert torch.equal(K.unpack_bits(bits), padded.to(torch.uint8))
    if mode["with_cov"]:
        for fn in (K.bilinear_cov_grads, K.bilinear_cov_grads_plain):
            with pytest.raises(ValueError, match="without coverage"):
                fn(bits, xy, **mode)
        return
    got = K.bilinear_cov_grads(bits, xy, **mode)
    assert torch.equal(got, K.bilinear_cov_grads(padded, xy, **mode))
    assert torch.equal(got, K.bilinear_cov_grads(img, xy, **mode))


def _crop_problem(rng, B=2, Vm=3, H=96, V=400):
    masks = np.zeros((B * Vm, H, H), np.float32)
    for i, m in enumerate(masks):
        m[10 + 3 * i: 80 - 2 * i, 20 + i: 70 - 3 * i] = 1.0
        m[40:50, 15 + 4 * i: 85] = 1.0
    contours, valid = tsil.extract_contours(list(masks))
    rc, rw = tsil.resample_contours(contours, valid, 64)
    crops, origins, _ = tsil.compute_mask_crops(list(masks))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    Kmat = np.array([[100.0, 0, H / 2], [0, 100.0, H / 2], [0, 0, 1]],
                    np.float32)

    def t(a, shape=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape((B, Vm) + a.shape[1:]) if shape is None
            else np.broadcast_to(a, shape)))

    verts = (rng.normal(size=(B, V, 3)) * 0.4).astype(np.float32)
    return dict(contours=t(rc), contour_valid=t(rw), masks=None,
                w2cs=t(w2c, (B, Vm, 4, 4)), Ks=t(Kmat, (B, Vm, 3, 3)),
                mask_crops=t(crops), mask_crop_origins=t(origins),
                mask_view_valid=torch.ones(B, Vm), verts=verts, H=H)


def _loss_and_grad(p, crops):
    v = torch.from_numpy(p["verts"]).requires_grad_(True)
    loss = tsil.silhouette_loss(
        p["contours"], p["contour_valid"], None, p["w2cs"], p["Ks"], v,
        vertex_stride=1, imsize=float(p["H"]), mask_crops=crops,
        mask_crop_origins=p["mask_crop_origins"],
        mask_view_valid=p["mask_view_valid"], full_hw=(p["H"], p["H"]))
    (g,) = torch.autograd.grad(loss.sum(), v)
    return loss.detach(), g


@pytest.mark.parametrize("Wc", [128, 100])
def test_silhouette_loss_on_bit_crops_equals_f32_exactly(rng, Wc):
    """The bit-mask crops (what fits sample) against the f32 crops: loss
    and vertex gradient bitwise, also for a crop width that the bit mask
    pads to a multiple of 32."""
    p = _crop_problem(rng)
    crops = p["mask_crops"]
    crops[..., Wc:] = 0.0
    crops = crops[..., :Wc].contiguous()
    bits = tsil.mask_crops_bits(crops)
    assert bits.dtype == torch.int32
    assert torch.equal(K.unpack_bits(bits)[..., :Wc], crops.to(torch.uint8))
    loss32, g32 = _loss_and_grad(p, crops)
    assert torch.isfinite(loss32).all() and (loss32 > 0).all()
    assert g32.abs().sum() > 0
    loss, g = _loss_and_grad(p, bits)
    assert torch.equal(loss, loss32)
    assert torch.equal(g, g32)


def _obs(crops):
    B, Vm = crops.shape[:2]
    return smplify.Observations(
        w2cs=torch.eye(4).expand(B, 2, 4, 4),
        Ks=torch.eye(3).expand(B, 2, 3, 3),
        keypoints=torch.zeros(B, 2, 3, 3), view_mask=torch.ones(B, 2),
        constant_scale=torch.ones(B), mask_crops=crops,
        mask_crop_origins=torch.zeros(B, Vm, 2))


def test_step_observations_copy_crops_to_a_bit_mask_once(rng):
    crops = torch.from_numpy((rng.random((2, 3, 8, 40)) > 0.5).astype(
        np.float32))
    obs = _obs(crops)
    step = smplify.step_observations(obs)
    assert step.mask_crops.dtype == torch.int32
    assert step.mask_crops.shape == (2, 3, 8, 2)
    assert torch.equal(K.unpack_bits(step.mask_crops)[..., :40],
                       crops.to(torch.uint8))
    assert obs.mask_crops is crops                    # f32 stays f32
    assert all(getattr(step, f.name) is getattr(obs, f.name)
               for f in dataclasses.fields(obs) if f.name != "mask_crops")
    no_crops = dataclasses.replace(obs, mask_crops=None)
    assert smplify.step_observations(no_crops) is no_crops


@pytest.mark.parametrize("bad", [0.5, 2.0, -1.0, float("nan")])
def test_crop_copy_raises_on_values_other_than_0_and_1(bad):
    crops = torch.zeros(1, 2, 8, 16)
    crops[0, 1, 3, 5] = bad
    with pytest.raises(ValueError, match="only 0 and 1"):
        tsil.mask_crops_bits(crops)
    with pytest.raises(ValueError, match="only 0 and 1"):
        smplify.step_observations(_obs(crops))


def test_launch_geometry_restates_the_cu():
    """``launch_geometry`` against the block size ``csrc/bilinear.cu``
    chooses, and at the main path's two calls: BV 64 x N 2,619 points
    (the stay-inside sample) in 655 blocks of 256 threads, a point a
    thread; BV 64 x N 512 (the lookup) in 128."""
    src = open(os.path.join(_build.CSRC, "bilinear.cu")).read()
    threads = re.search(r"constexpr int kThreads = (\d+);", src).group(1)
    assert bilinear.THREADS == int(threads)
    assert bilinear.launch_geometry(64, 2619) == dict(blocks=655,
                                                      threads=256)
    assert bilinear.launch_geometry(64, 512)["blocks"] == 128
    assert bilinear.launch_geometry(1, 1)["blocks"] == 1
    T = bilinear.THREADS
    for BV, N in ((3, 1001), (7, 3), (1, T), (1, T + 1)):
        assert bilinear.launch_geometry(BV, N)["blocks"] == -(-BV * N // T)
