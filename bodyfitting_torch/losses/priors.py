"""Pose priors: the GMM max-mixture and the L2 prior.

Counterpart of ``bodyfitting_tpu/losses/priors.py``.  The mixture's
inverses and determinants are precomputed on the host in float64 and
stored in the working dtype.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from bodyfitting_torch.device import default_device


@dataclasses.dataclass(frozen=True)
class MaxMixturePrior:
    """``nll(pose) = min_k [0.5 (pose-mu_k)^T P_k (pose-mu_k) - log w'_k]``."""

    means: torch.Tensor            # [K, D]
    precisions: torch.Tensor       # [K, D, D]
    log_nll_weights: torch.Tensor  # [K]
    mean_pose: torch.Tensor        # [D]

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose ``[..., D]`` -> nll ``[...]``."""
        diff = pose[..., None, :] - self.means               # [..., K, D]
        pd = torch.einsum("kij,...kj->...ki", self.precisions, diff)
        quad = torch.sum(pd * diff, dim=-1)                  # [..., K]
        nll = 0.5 * quad - self.log_nll_weights
        return torch.min(nll, dim=-1).values


def gmm_prior_from_arrays(means, precisions, log_nll_weights, mean_pose,
                          dtype=torch.float32, device=None
                          ) -> MaxMixturePrior:
    """A prior from its precomputed arrays (numpy or tensors)."""
    device = default_device(device)

    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    return MaxMixturePrior(means=t(means), precisions=t(precisions),
                           log_nll_weights=t(log_nll_weights),
                           mean_pose=t(mean_pose))


def _build(means, covs, weights, dtype, device) -> MaxMixturePrior:
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    weights = np.asarray(weights, np.float64)
    D = means.shape[1]
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (D / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))
    return gmm_prior_from_arrays(
        means, precisions, np.log(nll_weights), weights @ means,
        dtype=dtype, device=device,
    )


def load_gmm_prior(path: str, dtype=torch.float32,
                   device=None) -> MaxMixturePrior:
    """Load ``gmm_08.pkl`` (dict or legacy sklearn GMM pickle)."""
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
    else:
        means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
    return _build(means, covs, weights, dtype, device)


def synthetic_gmm_prior(num_gaussians: int = 8, dim: int = 69,
                        seed: int = 0, dtype=torch.float32,
                        device=None) -> MaxMixturePrior:
    """Random but well-conditioned mixture; the same RNG calls as the JAX
    fixture, so the same seed gives the same prior."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=0.3, size=(num_gaussians, dim))
    covs = []
    for _ in range(num_gaussians):
        A = rng.normal(size=(dim, dim)) * 0.05
        covs.append(A @ A.T + np.eye(dim) * 0.25)
    weights = rng.dirichlet(np.ones(num_gaussians))
    return _build(means, np.stack(covs), weights, dtype, device)


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """Sum-of-squares prior over the last axis."""
    return torch.sum(x ** 2, dim=-1)
