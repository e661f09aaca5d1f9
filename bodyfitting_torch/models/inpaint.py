"""LBAM image inpainting network (Xie et al. ICCV'19, "Image Inpainting
with Learnable Bidirectional Attention Maps") as a ``torch.nn.Module``.

Counterpart of ``bodyfitting_tpu/models/inpaint.py``: a 7-level encoder
whose features are gated by learnable asymmetric-gaussian activations of
mask features (forward attention), a 6-level reverse mask branch on
``1 - mask``, and a decoder whose skip-concatenated features are gated by
the concatenated forward and reverse attention maps.  Parameter names are
the released checkpoint's keys (``ec1.conv.conv.weight``,
``ec1.conv.activationFuncG_A.a``, ``reverseConv1.reverseMaskConv.weight``,
``dc1.conv.weight``, ``dc7.weight``, ...), so
``LBAM_NoBN_ParisStreetView.pth`` loads with
``load_state_dict(strict=True)``.  Tensors are NCHW.

Convolutions go through cuDNN on the card, which runs float32
convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False;
this module sets no global flag, callers choose.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bodyfitting_torch.device import default_device

KERNEL, STRIDE, PAD = 4, 2, 1
EC_CHANNELS = (64, 128, 256, 512, 512, 512, 512)
REVERSE_CHANNELS = (64, 128, 256, 512, 512, 512)
DC_CHANNELS = (512, 512, 512, 256, 128, 64)


def conv_down(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4x4, stride-2, pad-1 convolution without bias.  Where the padded
    input is smaller than the kernel, the result is an empty map, as XLA
    gives it (the JAX package's 64² runs reach this at the seventh level)
    and torch refuses."""
    h, wd = x.shape[-2:]
    if h + 2 * PAD < KERNEL or wd + 2 * PAD < KERNEL:
        return x.new_zeros((x.shape[0], w.shape[0], 0, 0))
    return F.conv2d(x, w, stride=STRIDE, padding=PAD)


def conv_up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d(4, stride 2, pad 1)`` without bias; ``w`` is
    (in, out, k, k).  An empty input gives the 1x1 map of zeros that the
    JAX package's lhs-dilated form gives (all padding)."""
    if x.shape[-1] == 0 or x.shape[-2] == 0:
        n = 2 * (KERNEL - 1 - PAD) - KERNEL + 1
        return x.new_zeros((x.shape[0], w.shape[1], n, n))
    return F.conv_transpose2d(x, w, stride=STRIDE, padding=PAD)


class _Conv(nn.Module):
    """Holds ``weight`` [out, in, 4, 4] (a bias-free ``nn.Conv2d``'s key)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, KERNEL, KERNEL))

    def forward(self, x):
        return conv_down(x, self.weight)


class _Deconv(nn.Module):
    """Holds ``weight`` [in, out, 4, 4] (a bias-free ``ConvTranspose2d``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, KERNEL, KERNEL))

    def forward(self, x):
        return conv_up(x, self.weight)


class GaussActivation(nn.Module):
    """Asymmetric gaussian gate g_A, parameters clipped to their ranges."""

    def __init__(self, a: float, mu: float, sigma1: float, sigma2: float):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(a))
        self.mu = nn.Parameter(torch.tensor(mu))
        self.sigma1 = nn.Parameter(torch.tensor(sigma1))
        self.sigma2 = nn.Parameter(torch.tensor(sigma2))

    def forward(self, x):
        a = torch.clamp(self.a, 1.01, 6.0)
        mu = torch.clamp(self.mu, 0.1, 3.0)
        s1 = torch.clamp(self.sigma1, 0.5, 2.0)
        s2 = torch.clamp(self.sigma2, 0.5, 2.0)
        left = a * torch.exp(-s1 * (x - mu) ** 2)
        right = 1 + (a - 1) * torch.exp(-s2 * (x - mu) ** 2)
        return torch.where(x < mu, left, right)


def mask_update(x, alpha: float = 0.8):
    """relu(x) ** alpha."""
    return torch.relu(x) ** alpha


class _ForwardAttentionLayer(nn.Module):
    def __init__(self, cin: int, cmask: int, cout: int):
        super().__init__()
        self.conv = _Conv(cin, cout)
        self.maskConv = _Conv(cmask, cout)
        self.activationFuncG_A = GaussActivation(1.1, 2.0, 1.0, 1.0)


class ForwardAttention(nn.Module):
    """Encoder level: feature conv gated by mask-feature attention."""

    def __init__(self, cin: int, cmask: int, cout: int):
        super().__init__()
        self.conv = _ForwardAttentionLayer(cin, cmask, cout)

    def forward(self, feats, masks):
        conv_f = self.conv.conv(feats)
        conv_m = self.conv.maskConv(masks)
        attn = self.conv.activationFuncG_A(conv_m)
        out = F.leaky_relu(conv_f * attn, 0.2)
        return out, mask_update(conv_m), conv_f, attn


class ReverseMaskConv(nn.Module):
    """Reverse mask branch level."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.reverseMaskConv = _Conv(cin, cout)
        self.activationFuncG_A = GaussActivation(1.1, 1.0, 0.5, 0.5)

    def forward(self, masks):
        m = self.reverseMaskConv(masks)
        return self.activationFuncG_A(m), mask_update(m)


class ReverseAttention(nn.Module):
    """Decoder level: deconv, skip concat, attention gate, leaky relu."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _Deconv(cin, cout)

    def forward(self, ec_skip, dc_feats, attn_map):
        up = self.conv(dc_feats)
        return F.leaky_relu(torch.cat([ec_skip, up], dim=1) * attn_map, 0.2)


class LBAM(nn.Module):
    """Generator: ``(image+mask [N, 4, H, W], mask [N, 3, H, W]) ->
    inpainted rgb [N, 3, H, W]`` in [0, 1]."""

    def __init__(self, out_channels: int = 3):
        super().__init__()
        cin, cmask = 4, 3
        for i, ch in enumerate(EC_CHANNELS):
            setattr(self, f"ec{i + 1}", ForwardAttention(cin, cmask, ch))
            cin = cmask = ch
        cin = 3
        for i, ch in enumerate(REVERSE_CHANNELS):
            setattr(self, f"reverseConv{i + 1}", ReverseMaskConv(cin, ch))
            cin = ch
        cin = EC_CHANNELS[-1]
        for i, ch in enumerate(DC_CHANNELS):
            setattr(self, f"dc{i + 1}", ReverseAttention(cin, ch))
            cin = 2 * ch
        self.dc7 = _Deconv(cin, out_channels)

    def forward(self, input_imgs, masks):
        feats, mu = input_imgs, masks
        skips, fmaps = [], []
        for i in range(len(EC_CHANNELS)):
            feats, mu, skip, fmap = getattr(self, f"ec{i + 1}")(feats, mu)
            skips.append(skip)
            fmaps.append(fmap)
        rmaps = []
        rmu = 1.0 - masks
        for i in range(len(REVERSE_CHANNELS)):
            rmap, rmu = getattr(self, f"reverseConv{i + 1}")(rmu)
            rmaps.append(rmap)
        dc = feats
        for i in range(len(DC_CHANNELS)):
            lvl = 6 - i                                   # level 6 .. 1
            attn = torch.cat([fmaps[lvl - 1], rmaps[lvl - 1]], dim=1)
            dc = getattr(self, f"dc{i + 1}")(skips[lvl - 1], dc, attn)
        return (torch.tanh(self.dc7(dc)) + 1.0) / 2.0


def seeded_state_dict(seed: int = 0) -> dict:
    """LBAM weights made from ``seed``, in the released checkpoint's layout
    (numpy arrays by key): convolution kernels normal with std
    ``1/sqrt(fan_in)``, transposed-convolution kernels normal(0.02), the
    gaussian gates at their initial values.  For runs without the released
    weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in LBAM().state_dict().items():
        shape = tuple(v.shape)
        if not shape:                                     # gauss scalars
            out[k] = np.asarray(v.numpy(), np.float32)
        elif k.startswith("dc"):
            out[k] = rng.normal(0.0, 0.02, size=shape).astype(np.float32)
        else:
            fan_in = shape[1] * shape[2] * shape[3]
            out[k] = rng.normal(0.0, fan_in ** -0.5,
                                size=shape).astype(np.float32)
    return out


class Inpainter:
    """The reference-compatible wrapper: fills masked regions of a uint8
    image and composites with the unmasked input (numpy HWC in and out).

    Weights: ``checkpoint_path`` (a released ``.pth`` state dict), else
    ``state_dict`` (arrays or tensors by key), else
    :func:`seeded_state_dict` of ``seed``.  Every key of the network must
    be present with its shape (``tools.manifests``; a ``ValueError``
    names each missing or mis-shaped key); extra keys are ignored, as
    the JAX package's converter ignores them.
    """

    def __init__(self, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[dict] = None, seed: int = 0,
                 device=None):
        from bodyfitting_torch.tools import manifests

        self.device = default_device(device)
        what = "LBAM state dict"
        if checkpoint_path is not None:
            state_dict = torch.load(checkpoint_path, map_location="cpu",
                                    weights_only=True)
            what = f"LBAM checkpoint {checkpoint_path}"
        elif state_dict is None:
            state_dict = seeded_state_dict(seed)
        self.model = LBAM()
        required, optional = manifests.expected_lbam_state_dict(self.model)
        manifests.verify_or_raise(state_dict, required, optional, what)
        sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v, dtype=torch.float32)
              for k, v in state_dict.items() if k in required}
        self.model.load_state_dict(sd, strict=True)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """image uint8 [H, W, 3], mask uint8 [H, W, 3] (255 = region to
        fill).  Returns float32 [H, W, 3] in [0, 1]."""
        img = np.asarray(image, np.float32) / 255.0
        m = (np.asarray(mask, np.float32) / 255.0 >= 0.5).astype(np.float32)
        keep = 1.0 - m                               # 1 = known pixels
        inp = np.concatenate([img * keep, keep[..., :1]], axis=-1)[None]

        def nchw(a):
            return torch.as_tensor(a.transpose(0, 3, 1, 2).copy(),
                                   device=self.device)

        out = self.model(nchw(inp), nchw(keep[None]))
        out = out[0].permute(1, 2, 0).cpu().numpy()
        return out * m + img * keep
