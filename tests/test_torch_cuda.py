"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present and run on the
card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.
Tolerances as in ``chip_smoke.py``: the sampler and the match round like
their plain versions (built with ``-fmad=false``), so they agree exactly;
the scatter is held to two launches being bitwise equal, and to the plain
``scatter_add_``, whose summation order differs, within 1e-6.
"""

import numpy as np
import pytest
import torch

from bodyfitting_torch.ops import kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(a, device=dev)


@pytest.mark.parametrize("with_grads,with_cov",
                         [(True, False), (False, False), (True, True)])
def test_bilinear_kernel_matches_plain(dev, with_grads, with_cov):
    rng = np.random.default_rng(0)
    H, W, N = 40, 300, 1001
    img = (rng.random((3, H, W)) > 0.5).astype(np.float32)
    xy = rng.uniform(-3, [W + 2, H + 2], size=(3, N, 2)).astype(np.float32)
    xy[:, :20] = np.round(xy[:, :20])
    xy[:, 20] = [1e9, 5.0]
    xy[:, 21] = [np.nan, 3.0]
    img, xy = _t(img, dev), _t(xy, dev)
    before = K.bilinear_cov_grads.launches
    got = K.bilinear_cov_grads(img, xy, with_grads, with_cov)
    ref = K.bilinear_cov_grads_plain(img, xy, with_grads, with_cov)
    torch.cuda.synchronize()
    assert K.bilinear_cov_grads.launches == before + 1
    assert torch.equal(got, ref)


def test_contour_match_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    P, M = 700, 2600
    proj = rng.uniform(0, 64, size=(2, M, 2)).astype(np.float32)
    proj[:, 1500:1550] = proj[:, :50]                  # ties across tiles
    contour = np.round(rng.uniform(-5, 70, size=(2, P, 2))).astype(np.float32)
    valid = (rng.random((2, M)) > 0.3).astype(np.float32)
    valid[1] = 0.0                                     # an all-invalid row
    inside = (rng.random((2, M)) > 0.5).astype(np.float32)
    args = [_t(a, dev) for a in (contour, proj, valid, inside)]
    got = K.contour_match_full(*args)
    ref = K.contour_match_full_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[1][1].abs().sum()) == 0
    d2, idx = K.contour_min_idx(*args[:3])
    assert torch.equal(idx, ref[1]) and torch.equal(d2, ref[0])


def test_rows_scatter_kernel_is_deterministic_and_matches_plain(dev):
    rng = np.random.default_rng(2)
    P, M = 512, 2619
    idx = rng.integers(-5, M + 40, size=(4, P)).astype(np.int32)
    idx[:, :60] = 7
    g = rng.normal(size=(4, P, 2)).astype(np.float32)
    idx, g = _t(idx, dev), _t(g, dev)
    a = K.rows_scatter_add(idx, g, M)
    b = K.rows_scatter_add(idx, g, M)
    ref = K.rows_scatter_add_plain(idx, g, M)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref, rtol=0, atol=1e-6 * 60)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    img = torch.zeros((1, 8, 8), device=dev)
    xy = torch.zeros((1, 4, 2), device=dev)
    with pytest.raises(ValueError):
        K.bilinear_cov_grads(img.double(), xy.double())
    with pytest.raises(ValueError):
        K.bilinear_cov_grads(img, xy.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    with pytest.raises(ValueError):
        K.rows_scatter_add(torch.zeros((1, 4), dtype=torch.int64, device=dev),
                           torch.zeros((1, 4, 2), device=dev), 8)
