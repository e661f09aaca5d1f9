"""The silhouette work's share of its roofline in the traced slice: the
least time of one post-gate step's stay-inside sample, matched-pixel
lookup, contour match and scatter at the cell's shapes
(``counts.silhouette``), times the slice's post-gate steps, over the
device time of the kernels that carry that work on either mask route."""

from benchmark import counts

# Device symbols: the separate route's sampler, match and scatter
# (``bilinear_cov_grads``, ``contour_match_full``, ``rows_scatter_add``)
# and the fused route's ``mask_terms_forward`` (points and sums kernels)
# and ``mask_terms_backward``.
KERNELS = ("bilinear_cov_grads", "contour_match_full", "rows_scatter_add",
           "mask_terms_points", "mask_terms_sums", "mask_terms_backward")


def read(run):
    t = run["trace"]
    if not t:
        return None
    spent = sum(b - a for name, a, b in t["device"]
                if any(k in name for k in KERNELS)) * 1e-6
    first, last = t["slice"]
    post = last - max(first, t["gate"] + 1)
    if spent <= 0 or post <= 0:
        return None
    frames = len(run["traced"][0]["frames"])
    ops, nbytes = counts.silhouette(run["cell"]["config"], frames)
    return 100.0 * counts.bound_s(nbytes, ops)[0] * post / spent
