"""HMR (ResNet-50 + iterative-error-feedback head) as a ``torch.nn.Module``.

Counterpart of ``bodyfitting_tpu/models/hmr.py``, the network that seeds
SMPLify from the keyframe.  The module names are the reference
checkpoint's own (``conv1``, ``bn1``, ``layer{1-4}.{i}.conv1 ...
downsample.{0,1}``, ``fc1``, ``fc2``, ``decpose``, ``decshape``,
``deccam``), so the released torch checkpoint loads as it is.  Inputs are
NHWC ImageNet-normalised ``[B, 224, 224, 3]`` images, as in the JAX
package; batch norm runs on its running statistics (eval mode).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from bodyfitting_torch.ops.rotations import rot6d_to_rotmat

NPOSE = 24 * 6


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4),
        ) if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + r)


class HMR(nn.Module):
    """``forward(x [B, 224, 224, 3], init_pose, init_shape, init_cam)`` ->
    ``(rotmat [B, 24, 3, 3], shape [B, 10], cam [B, 3])``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 n_iter: int = 3):
        super().__init__()
        self.n_iter = n_iter
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.fc1 = nn.Linear(inplanes + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        self.eval()

    def forward(self, x, init_pose, init_shape, init_cam):
        y = x.permute(0, 3, 1, 2)
        y = torch.relu(self.bn1(self.conv1(y)))
        y = nn.functional.max_pool2d(y, 3, 2, 1)
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        xf = y.mean(dim=(2, 3))
        pose, shape, cam = init_pose, init_shape, init_cam
        for _ in range(self.n_iter):
            xc = self.fc2(self.fc1(torch.cat([xf, pose, shape, cam], 1)))
            pose = self.decpose(xc) + pose
            shape = self.decshape(xc) + shape
            cam = self.deccam(xc) + cam
        rotmat = rot6d_to_rotmat(pose.reshape(x.shape[0], 24, 6))
        return rotmat, shape, cam


def load_mean_params(path: Optional[str] = None):
    """``smpl_mean_params.npz`` -> ``(pose6d [144], shape [10], cam [3])``;
    without the asset the neutral init: identity 6D rotations, zero
    shape, weak-perspective camera ``[0.9, 0, 0]``."""
    if path is not None:
        d = np.load(path)
        return (d["pose"].astype(np.float32), d["shape"].astype(np.float32),
                d["cam"].astype(np.float32))
    ident6d = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)
    return ident6d, np.zeros(10, np.float32), np.array([0.9, 0.0, 0.0],
                                                       np.float32)


def seeded_state_dict(seed: int = 0, layers=(3, 4, 6, 3)) -> dict:
    """Seeded weights in the checkpoint's layout (no licensed asset
    needed): PyTorch's default initialisation from ``seed``, the three
    output heads at Xavier gain 0.01 as SPIN initialises them, so the
    head stays near the mean parameters; batch-norm statistics at
    their defaults."""
    gen = torch.random.fork_rng(devices=[])
    with gen:
        torch.manual_seed(seed)
        net = HMR(layers)
        for head in (net.decpose, net.decshape, net.deccam):
            nn.init.xavier_uniform_(head.weight, gain=0.01)
    return net.state_dict()


def load_state_dict_checked(net: HMR, state_dict: dict) -> None:
    """Load the reference checkpoint (or a SPIN wrapper with a ``model``
    key) into ``net``: every tensor of the network must be present with
    its shape (``tools.manifests.expected_hmr_state_dict``; a
    ``ValueError`` names each missing or mis-shaped key); keys the
    network has no use for are ignored, as the reference's non-strict
    load does."""
    from bodyfitting_torch.tools import manifests

    if "model" in state_dict and isinstance(state_dict["model"], dict):
        state_dict = state_dict["model"]
    required, optional = manifests.expected_hmr_state_dict(net)
    manifests.verify_or_raise(state_dict, required, optional,
                              "HMR checkpoint")
    keys = set(net.state_dict())
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in state_dict.items() if k in keys}
    net.load_state_dict(sd, strict=False)


def hmr_forward(net: HMR, images: torch.Tensor, mean_params=None):
    """``images [B, 224, 224, 3]`` -> ``(rotmat [B, 24, 3, 3], shape, cam)``
    from the mean parameters (the neutral ones by default)."""
    pose, shape, cam = (mean_params if mean_params is not None
                        else load_mean_params())
    B = images.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=images.dtype,
                               device=images.device)[None].expand(B, -1)

    with torch.no_grad():
        return net(images, t(pose), t(shape), t(cam))
