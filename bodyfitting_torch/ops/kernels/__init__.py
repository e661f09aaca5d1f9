"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; :func:`reset_launch_counts` and :func:`launch_counts` read
them together.
"""

from bodyfitting_torch.ops.kernels.bilinear import (
    bilinear_cov_grads,
    bilinear_cov_grads_plain,
)
from bodyfitting_torch.ops.kernels.contour_match import (
    contour_match_full,
    contour_match_full_plain,
    contour_min_idx,
)
from bodyfitting_torch.ops.kernels.nearest import (
    nearest_d2_idx,
    nearest_d2_idx_plain,
)
from bodyfitting_torch.ops.kernels.rows_scatter import (
    rows_scatter_add,
    rows_scatter_add_plain,
)

KERNELS = (bilinear_cov_grads, contour_match_full, rows_scatter_add,
           nearest_d2_idx)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "bilinear_cov_grads", "bilinear_cov_grads_plain",
    "contour_match_full", "contour_match_full_plain", "contour_min_idx",
    "rows_scatter_add", "rows_scatter_add_plain",
    "nearest_d2_idx", "nearest_d2_idx_plain",
    "KERNELS", "reset_launch_counts", "launch_counts",
]
