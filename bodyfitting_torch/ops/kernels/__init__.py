"""Hand-written CUDA kernels of the port, each beside its plain version.

Each wrapper counts its kernel launches in a plain integer attribute
``launches``; :func:`reset_launch_counts` and :func:`launch_counts` read
them together.
"""

from bodyfitting_torch.ops.kernels.bilinear import (
    bilinear_cov_grads,
    bilinear_cov_grads_plain,
    pack_bits,
    unpack_bits,
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
from bodyfitting_torch.ops.kernels.raster import (
    rasterize_attrs,
    rasterize_attrs_plain,
    rasterize_zbuf,
    rasterize_zbuf_plain,
)
from bodyfitting_torch.ops.kernels.rows_scatter import (
    rows_scatter_add,
    rows_scatter_add_plain,
)
from bodyfitting_torch.ops.kernels.skinning import (
    fused_skinning,
    skin_backward,
    skin_backward_plain,
    skin_forward,
    skin_forward_plain,
)

KERNELS = (bilinear_cov_grads, contour_match_full, rows_scatter_add,
           nearest_d2_idx, rasterize_zbuf, rasterize_attrs, skin_forward,
           skin_backward)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "bilinear_cov_grads", "bilinear_cov_grads_plain", "pack_bits",
    "unpack_bits",
    "contour_match_full", "contour_match_full_plain", "contour_min_idx",
    "rows_scatter_add", "rows_scatter_add_plain",
    "nearest_d2_idx", "nearest_d2_idx_plain",
    "rasterize_zbuf", "rasterize_zbuf_plain",
    "rasterize_attrs", "rasterize_attrs_plain",
    "skin_forward", "skin_forward_plain", "skin_backward",
    "skin_backward_plain", "fused_skinning",
    "KERNELS", "reset_launch_counts", "launch_counts",
]
