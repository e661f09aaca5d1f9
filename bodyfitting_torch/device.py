"""Device selection: the port runs on the GPU unless asked for the CPU."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` when given, else ``cuda``.

    Raises when no CUDA device is present and the caller did not ask for
    a device explicitly: a fit silently moved to the CPU would run orders
    of magnitude slower, so the CPU is opt-in (``device="cpu"``).
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return torch.device("cuda")

