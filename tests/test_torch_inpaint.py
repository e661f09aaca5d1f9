"""The port's LBAM against the JAX package's Flax LBAM.

The Flax variables (the JAX ``Inpainter``'s seeded init) go across
through ``convert.lbam_state_dict_from_flax`` into the checkpoint's key
layout and load strict.  Outputs agree to 2e-4, the JAX package's own
tolerance between its Flax network and a torch build
(``tests/test_inpaint.py``): f32 convolutions in another summation
order, through 13 levels.  At 64² the Flax network's seventh level is
empty (a 1x1 map under a 4x4 stride-2 kernel); the port reproduces
XLA's empty map and the all-padding transposed convolution after it.
"""

import jax
import numpy as np
import pytest
import torch

from bodyfitting_tpu.models import inpaint as jlbam
from bodyfitting_tpu.tools.manifests import expected_lbam_state_dict
from bodyfitting_torch.convert import lbam_state_dict_from_flax
from bodyfitting_torch.models import inpaint as tlbam


@pytest.fixture(scope="module")
def flax_inpainter():
    return jlbam.Inpainter()


def _numpy_vars(inp):
    return jax.tree.map(np.asarray, inp.variables)


def _torch_lbam(sd):
    net = tlbam.LBAM()
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                        strict=True)
    return net.eval()


@pytest.mark.parametrize("H", [64, 128])
def test_lbam_matches_flax(flax_inpainter, H):
    sd = lbam_state_dict_from_flax(_numpy_vars(flax_inpainter))
    net = _torch_lbam(sd)
    rng = np.random.default_rng(H)
    img = rng.uniform(size=(1, H, H, 4)).astype(np.float32)
    mask = rng.integers(0, 2, size=(1, H, H, 1)).astype(np.float32)
    img[..., 3:] = mask
    mask3 = np.repeat(mask, 3, axis=-1)
    want = np.asarray(flax_inpainter.model.apply(
        flax_inpainter.variables, img, mask3))
    with torch.no_grad():
        got = net(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                  torch.from_numpy(mask3.transpose(0, 3, 1, 2).copy()))
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, H, H, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_inpainter_matches_flax_and_composites(flax_inpainter):
    sd = lbam_state_dict_from_flax(_numpy_vars(flax_inpainter))
    inp = tlbam.Inpainter(state_dict=sd, device="cpu")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=(128, 128, 3)).astype(np.uint8)
    mask = np.zeros((128, 128, 3), np.uint8)
    mask[40:80, 30:90] = 255
    got = inp(img, mask)
    want = flax_inpainter(img, mask)
    assert got.shape == (128, 128, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    # unmasked pixels pass through exactly
    np.testing.assert_array_equal(got[:30], img[:30] / np.float32(255.0))


def test_checkpoint_layout_loads_strict(flax_inpainter, tmp_path):
    """A state dict keyed and shaped as ``expected_lbam_state_dict`` (the
    released checkpoint's manifest) loads with ``strict=True``, and the
    converter and the seeded weights produce exactly those keys."""
    required, _ = expected_lbam_state_dict(flax_inpainter.variables)
    zeros = {k: torch.zeros(s) for k, s in required.items()}
    tlbam.LBAM().load_state_dict(zeros, strict=True)
    sd = lbam_state_dict_from_flax(_numpy_vars(flax_inpainter))
    assert {k: v.shape for k, v in sd.items()} == required
    seeded = tlbam.seeded_state_dict(3)
    assert {k: v.shape for k, v in seeded.items()} == required
    # a checkpoint file round-trips
    path = tmp_path / "lbam.pth"
    torch.save({k: torch.as_tensor(v) for k, v in seeded.items()}, path)
    a = tlbam.Inpainter(checkpoint_path=str(path), device="cpu")
    b = tlbam.Inpainter(seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(RuntimeError):
        tlbam.LBAM().load_state_dict(
            {k: v for k, v in zeros.items() if k != "dc7.weight"},
            strict=True)
