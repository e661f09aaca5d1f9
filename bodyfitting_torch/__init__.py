"""PyTorch/CUDA port of ``bodyfitting_tpu`` for one NVIDIA H100.

Module names mirror the JAX package so each counterpart is easy to find.
Frames are a leading tensor axis (JAX's ``vmap``) and views a second one.
The hot silhouette ops run through hand-written CUDA kernels
(``ops/csrc``), each beside a plain PyTorch version of the same contract
that serves CPU tensors.

This package imports neither ``jax`` nor ``bodyfitting_tpu``.
"""

from bodyfitting_torch.device import default_device

__all__ = ["default_device"]
