"""OpenPose body, hand and face networks as ``torch.nn.Module``\\ s.

Counterpart of ``bodyfitting_tpu/models/openpose.py``: the VGG19-prefix
backbone with six CPM stages producing 38 PAF + 19 heatmap channels at
stride 8 (body), the 22-channel hand network and the 71-channel face
network.  Parameters are named by the released files' flat layer names
(``conv1_1.weight``, ``Mconv7_stage6_L2.bias``, ...), so a released
``body_pose_model.pth`` / ``hand_pose_model.pth`` / ``face_pose_model.pth``
(or one saved with a block prefix such as ``model0.``) loads with
``load_state_dict`` after ``tools.manifests.normalize_openpose_keys``.

Inputs are NCHW ``[B, 3, H, W]`` images scaled as ``x / 256 - 0.5``;
the convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card),
as the JAX package runs ``lax.conv``.  The package sets no precision
flag: PyTorch's ``torch.backends.cudnn.allow_tf32`` decides whether the
card runs them on TF32 tensor cores.

A file's keys and shapes are checked before a load by
``tools/manifests.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bodyfitting_torch.device import default_device
from bodyfitting_torch.tools import manifests

_VGG_BODY = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool",),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool",),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool",),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
]
_VGG_HAND_FACE = _VGG_BODY[:11] + [
    ("conv4_1", 512, 3), ("conv4_2", 512, 3), ("conv4_3", 512, 3),
    ("conv4_4", 512, 3), ("conv5_1", 512, 3), ("conv5_2", 512, 3),
    ("conv5_3_CPM", 128, 3),
]


class _PoseNet(nn.Module):
    """Layers registered under their released names; ``_conv(name, x)``
    applies one with ``k // 2`` padding and, unless it is a head's last
    layer, a ReLU."""

    def _add(self, name: str, cin: int, cout: int, k: int) -> int:
        setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))
        return cout

    def _add_backbone(self, spec) -> int:
        c = 3
        for s in spec:
            if s[0] != "pool":
                c = self._add(s[0], c, s[1], s[2])
        return c

    def _backbone(self, spec, x):
        for s in spec:
            x = (F.max_pool2d(x, 2, 2) if s[0] == "pool"
                 else self._conv(s[0], x))
        return x

    def _conv(self, name: str, x, relu: bool = True):
        y = getattr(self, name)(x)
        return torch.relu(y) if relu else y


class BodyPoseNet(_PoseNet):
    """``[B, 3, H, W]`` -> ``(paf [B, 38, H/8, W/8], heatmap [B, 19, H/8,
    W/8])``."""

    n_out = (38, 19)

    def __init__(self):
        super().__init__()
        feat = self._add_backbone(_VGG_BODY)
        for L, out_ch in ((1, 38), (2, 19)):
            c = feat
            for i in range(1, 4):
                c = self._add(f"conv5_{i}_CPM_L{L}", c, 128, 3)
            c = self._add(f"conv5_4_CPM_L{L}", c, 512, 1)
            self._add(f"conv5_5_CPM_L{L}", c, out_ch, 1)
            for stage in range(2, 7):
                c = 38 + 19 + feat                            # 185
                for i in range(1, 6):
                    c = self._add(f"Mconv{i}_stage{stage}_L{L}", c, 128, 7)
                c = self._add(f"Mconv6_stage{stage}_L{L}", c, 128, 1)
                self._add(f"Mconv7_stage{stage}_L{L}", c, out_ch, 1)
        self.eval()

    def _branch(self, stage: int, L: int, y):
        if stage == 1:
            for i in range(1, 4):
                y = self._conv(f"conv5_{i}_CPM_L{L}", y)
            y = self._conv(f"conv5_4_CPM_L{L}", y)
            return self._conv(f"conv5_5_CPM_L{L}", y, relu=False)
        for i in range(1, 6):
            y = self._conv(f"Mconv{i}_stage{stage}_L{L}", y)
        y = self._conv(f"Mconv6_stage{stage}_L{L}", y)
        return self._conv(f"Mconv7_stage{stage}_L{L}", y, relu=False)

    def forward(self, x):
        feat = self._backbone(_VGG_BODY, x)
        paf, hm = self._branch(1, 1, feat), self._branch(1, 2, feat)
        for stage in range(2, 7):
            inp = torch.cat([paf, hm, feat], dim=1)
            paf, hm = self._branch(stage, 1, inp), self._branch(stage, 2, inp)
        return paf, hm


class _CropPoseNet(_PoseNet):
    """The hand and face networks: the full VGG19 prefix, a 1x1 stage-1
    head and five refinement stages over ``cat([y, feat])``."""

    def __init__(self, n_out: int):
        super().__init__()
        self.n_out = (n_out,)
        feat = self._add_backbone(_VGG_HAND_FACE)
        c = self._add("conv6_1_CPM", feat, 512, 1)
        self._add("conv6_2_CPM", c, n_out, 1)
        for stage in range(2, 7):
            c = n_out + feat
            for i in range(1, 6):
                c = self._add(f"Mconv{i}_stage{stage}", c, 128, 7)
            c = self._add(f"Mconv6_stage{stage}", c, 128, 1)
            self._add(f"Mconv7_stage{stage}", c, n_out, 1)
        self.eval()

    def forward(self, x):
        feat = self._backbone(_VGG_HAND_FACE, x)
        y = self._conv("conv6_1_CPM", feat)
        y = self._conv("conv6_2_CPM", y, relu=False)
        for stage in range(2, 7):
            inp = torch.cat([y, feat], dim=1)
            for i in range(1, 6):
                inp = self._conv(f"Mconv{i}_stage{stage}", inp)
            inp = self._conv(f"Mconv6_stage{stage}", inp)
            y = self._conv(f"Mconv7_stage{stage}", inp, relu=False)
        return y


class HandPoseNet(_CropPoseNet):
    """``[B, 3, H, W]`` -> heatmaps ``[B, 22, H/8, W/8]`` (21 + background)."""

    def __init__(self):
        super().__init__(22)


class FacePoseNet(_CropPoseNet):
    """``[B, 3, H, W]`` -> heatmaps ``[B, 71, H/8, W/8]`` (70 + background):
    CMU's ``pose_iter_116000`` face network."""

    def __init__(self):
        super().__init__(71)


NETS = {"body": BodyPoseNet, "hand": HandPoseNet, "face": FacePoseNet}


def seeded_state_dict(kind: str, seed: int = 0) -> dict:
    """Seeded weights for the ``kind`` net ("body", "hand" or "face") in the
    released flat layout, drawn from an explicit generator: He-normal
    kernels (the ReLU stack keeps its scale through ~40 layers) and zero
    biases.  Random nets give maps of arbitrary scale: a caller that needs
    realistic peak counts sets the last stage's heads itself."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in net_structure(kind).state_dict().items():
        if k.endswith(".weight"):
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            out[k] = torch.randn(v.shape, generator=gen) * math.sqrt(
                2.0 / fan_in)
        else:
            out[k] = torch.zeros(v.shape)
    return out


def net_structure(kind: str) -> nn.Module:
    """The ``kind`` net's structure without storage (no initialisation
    draws from the global generator)."""
    with torch.device("meta"):
        return NETS[kind]()


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def net_from_state_dict(kind: str, state_dict: dict, device=None,
                        what: str = "") -> nn.Module:
    """The ``kind`` net with the weights of a released file's state dict
    (flat or block-prefixed keys), checked against
    ``tools.manifests.expected_openpose_state_dict`` first (a
    ``ValueError`` names ``what`` and each missing or mis-shaped key;
    extra keys are ignored); on ``device`` (default ``cuda``)."""
    device = default_device(device)
    net = net_structure(kind)
    sd = manifests.normalize_openpose_keys(state_dict)
    required, optional = manifests.expected_openpose_state_dict(net)
    manifests.verify_or_raise(sd, required, optional,
                              what or f"OpenPose {kind} state dict")
    net.load_state_dict({k: sd[k] for k in required}, assign=True)
    net.requires_grad_(False)
    net = net.to(device)
    if device.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    return net


def _load_net(kind: str, checkpoint_path: Optional[str], device=None,
              seed: int = 0) -> nn.Module:
    device = default_device(device)
    if checkpoint_path is None:
        return net_from_state_dict(kind, seeded_state_dict(kind, seed),
                                   device)
    raw = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    return net_from_state_dict(kind, raw, device,
                               f"OpenPose {kind} checkpoint {checkpoint_path}")


def load_body_net(checkpoint_path: Optional[str] = None, device=None,
                  seed: int = 0) -> BodyPoseNet:
    """The body net from a released ``.pth`` (flat or block-prefixed keys,
    checked before the load), or seeded weights when ``None``; on
    ``device`` (default ``cuda``; raises without a card)."""
    return _load_net("body", checkpoint_path, device, seed)


def load_hand_net(checkpoint_path: Optional[str] = None, device=None,
                  seed: int = 0) -> HandPoseNet:
    """The hand net; see :func:`load_body_net`."""
    return _load_net("hand", checkpoint_path, device, seed)


def load_face_net(checkpoint_path: Optional[str] = None, device=None,
                  seed: int = 0) -> FacePoseNet:
    """The face net (a torch port of ``pose_iter_116000``); see
    :func:`load_body_net`."""
    return _load_net("face", checkpoint_path, device, seed)
