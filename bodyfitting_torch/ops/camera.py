"""Pinhole projection, batched over leading dimensions.

Counterpart of ``bodyfitting_tpu/ops/camera.py:perspective_projection``.
"""

from __future__ import annotations

import torch


def perspective_projection(
    points: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """World points ``[..., N, 3]`` to pixels ``[..., N, 2]``:
    ``K (R x + t)`` then the perspective divide.

    The divide is deliberately unguarded (the reference's behaviour): a
    point at camera depth 0 projects to inf/nan, and callers mask such
    points by their in-image test.
    """
    cam = torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]
    proj = torch.einsum("...ij,...nj->...ni", K, cam)
    return proj[..., :2] / proj[..., 2:3]
