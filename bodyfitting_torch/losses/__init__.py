"""Fitting losses: keypoint reprojection, priors, silhouette, mesh terms.

The export list of ``bodyfitting_tpu.losses``, name for name.
"""

from bodyfitting_torch.losses.keypoints import (  # noqa: F401
    gmof,
    reprojection_loss,
    angle_prior,
    multiview_keypoint_loss,
)
from bodyfitting_torch.losses.priors import (  # noqa: F401
    MaxMixturePrior,
    load_gmm_prior,
    synthetic_gmm_prior,
    l2_prior,
)
from bodyfitting_torch.losses.mesh import (  # noqa: F401
    compute_vertex_normals,
    compute_face_normals,
    point_cloud_loss,
    normal_loss,
    normal_laplacian_smoothness,
    chamfer_loss,
)
from bodyfitting_torch.losses.silhouette import (  # noqa: F401
    extract_contours,
    resample_contours,
    silhouette_loss,
)
