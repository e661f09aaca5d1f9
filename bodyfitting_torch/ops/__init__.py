"""Differentiable geometry ops: rotations, cameras, meshes, the CUDA
kernels' entry points.

The export list of ``bodyfitting_tpu.ops``, name for name.  Importing
builds no kernel (each builds at its first launch on a card).
"""

from bodyfitting_torch.ops.rotations import (  # noqa: F401
    rodrigues,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_rot6d,
    rotmat_to_quat,
    rotmat_to_aa,
)
from bodyfitting_torch.ops.camera import (  # noqa: F401
    perspective_projection,
    world_to_camera,
    adjust_intrinsics_for_crop,
    invert_rigid,
)
from bodyfitting_torch.ops.nearest import (  # noqa: F401
    nearest_point_on_mesh,
    nearest_points,
    closest_point_on_triangles,
)
# The rasterize() function is not re-exported: it would shadow the
# `bodyfitting_torch.ops.rasterize` module; use ops.rasterize.rasterize.
from bodyfitting_torch.ops.rasterize import (  # noqa: F401
    project_faces,
    render_attributes,
    render_silhouette,
    render_depth,
    sample_texture,
    soft_silhouette,
)
from bodyfitting_torch.ops.mesh_queries import (  # noqa: F401
    inside_mesh,
    intersects_any,
)
from bodyfitting_torch.ops.sdf import (  # noqa: F401
    DistanceVolume,
    build_distance_volume,
    query_distance,
)
from bodyfitting_torch.ops.geometry import estimate_translation  # noqa: F401
