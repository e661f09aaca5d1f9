"""Plain distance volume of a scan: the unsigned distance from each cell
centre of a padded cubic grid to the nearest scan triangle, and that
triangle (the lowest index among those tied with the minimum), read
back through the trilinear lookup the fits use.

Only the cells a query touches are computed, each against every
triangle that its bounding box cannot rule out: exact, dense, and no
faster than it has to be.
"""

from __future__ import annotations

import torch


def closest_point(p, a, b, c):
    """The closest point to ``p`` on triangle ``(a, b, c)``, by Voronoi
    region (Ericson, Real-Time Collision Detection, 5.1.5); all
    ``[..., 3]``."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp = p - b
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    cp = p - c
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2

    def div(n, d):
        return n / torch.where(d.abs() > 1e-300, d, torch.full_like(d, 1e-300))

    den = div(torch.ones_like(va), va + vb + vc)
    out = a + ab * (vb * den)[..., None] + ac * (vc * den)[..., None]
    t_bc = div(d4 - d3, (d4 - d3) + (d5 - d6)).clamp(0, 1)[..., None]
    t_ac = div(d2, d2 - d6).clamp(0, 1)[..., None]
    t_ab = div(d1, d1 - d3).clamp(0, 1)[..., None]
    for cond, q in (((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
                     b + t_bc * (c - b)),
                    ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac * ac),
                    ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab * ab),
                    ((d6 >= 0) & (d5 <= d6), c.expand_as(out)),
                    ((d3 >= 0) & (d4 <= d3), b.expand_as(out)),
                    ((d1 <= 0) & (d2 <= 0), a.expand_as(out))):
        out = torch.where(cond[..., None], q, out)
    return out


class Volume:
    """The ``R``³ volume of the scan ``(verts [V, 3], faces [F, 3])``
    over its bounding box grown by 15 % of its largest extent a side;
    cells are computed when first read and kept.  Faces within ``32 eps
    (d2 + diag^2)`` of the minimum tie (``eps`` of the working dtype),
    and the lowest index wins."""

    def __init__(self, verts, faces, resolution=96, chunk=256):
        self.verts, self.faces = verts, faces
        self.R = resolution
        vmin, vmax = verts.min(0).values, verts.max(0).values
        pad = (vmax - vmin).max() * 0.15
        lo, hi = vmin - pad, vmax + pad
        self.origin = lo
        self.spacing = (hi - lo).max() / (resolution - 1)
        self.tri = verts[faces]                              # [F, 3, 3]
        self.lo, self.hi = self.tri.min(1).values, self.tri.max(1).values
        self.diag2 = ((vmax - vmin) ** 2).sum()
        self.eps = torch.finfo(verts.dtype).eps
        self.chunk = chunk
        self.known = {}                                      # cell -> (d, f)

    def centres(self, cells):
        R = self.R
        ijk = torch.stack([cells // (R * R), (cells // R) % R, cells % R], -1)
        return self.origin + self.spacing * ijk.to(self.verts.dtype)

    def _solve(self, cells):
        """``(distance, face)`` of each cell id in ``cells``."""
        dist = torch.empty(len(cells), dtype=self.verts.dtype,
                           device=self.verts.device)
        face = torch.empty(len(cells), dtype=torch.int64,
                           device=self.verts.device)
        pts = self.centres(cells)
        for s in range(0, len(cells), self.chunk):
            p = pts[s:s + self.chunk]
            # the nearest vertex bounds the distance from above, a face's
            # box bounds its own from below
            ub = torch.cdist(p, self.verts, compute_mode=(
                "donot_use_mm_for_euclid_dist")).min(1).values
            box2 = 0.0
            for k in range(3):
                e = (torch.clamp(self.lo[:, k] - p[:, k, None], min=0)
                     + torch.clamp(p[:, k, None] - self.hi[:, k], min=0))
                box2 = box2 + e * e                          # [c, F]
            q, f = torch.nonzero(box2 <= (ub * ub)[:, None] * (1 + 1e-9)
                                 + 1e-12, as_tuple=True)
            t = self.tri[f]
            d2 = ((p[q] - closest_point(p[q], t[:, 0], t[:, 1], t[:, 2]))
                  ** 2).sum(-1)
            n = len(p)
            best = torch.full((n,), float("inf"), dtype=d2.dtype,
                              device=d2.device).scatter_reduce(
                0, q, d2, "amin")
            thr = best + 32 * self.eps * (best + self.diag2)
            cand = torch.where(d2 <= thr[q], f, torch.full_like(f, 2 ** 62))
            low = torch.full((n,), 2 ** 62, dtype=torch.int64,
                             device=d2.device).scatter_reduce(
                0, q, cand, "amin")
            dist[s:s + n] = torch.sqrt(best)
            face[s:s + n] = low
        return dist, face

    def cells(self, cells):
        """``(distance, face)`` of the cell ids ``cells`` (any shape)."""
        flat = cells.reshape(-1)
        uniq, inv = torch.unique(flat, return_inverse=True)
        ids = uniq.tolist()
        new = [c for c in ids if c not in self.known]
        if new:
            d, f = self._solve(torch.as_tensor(new, device=flat.device))
            for c, dv, fv in zip(new, d.tolist(), f.tolist()):
                self.known[c] = (dv, fv)
        d = torch.as_tensor([self.known[c][0] for c in ids],
                            dtype=self.verts.dtype, device=flat.device)
        f = torch.as_tensor([self.known[c][1] for c in ids],
                            device=flat.device)
        return d[inv].reshape(cells.shape), f[inv].reshape(cells.shape)

    def query(self, points):
        """Trilinear distance at ``points [Q, 3]`` plus the distance to the
        volume from points outside it; differentiable in ``points``."""
        R = self.R
        g_raw = (points - self.origin) / self.spacing
        g = torch.clamp(g_raw, 0.0, R - 1 - 1e-5)
        outside = torch.sqrt(((g_raw - g) ** 2).sum(-1) + 1e-20) * self.spacing
        g0 = torch.floor(g).detach()
        w = g - g0
        i0 = g0.long()
        out = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    off = torch.as_tensor([dx, dy, dz], device=i0.device)
                    i = (i0 + off).clamp(max=R - 1)
                    d, _ = self.cells((i[:, 0] * R + i[:, 1]) * R + i[:, 2])
                    wx = w[:, 0] if dx else 1 - w[:, 0]
                    wy = w[:, 1] if dy else 1 - w[:, 1]
                    wz = w[:, 2] if dz else 1 - w[:, 2]
                    out = out + d * wx * wy * wz
        return out + outside

    def nearest_face(self, points):
        """The face of the cell nearest each point (rounded half to even,
        clamped to the grid)."""
        R = self.R
        i = torch.clamp(torch.round((points - self.origin) / self.spacing),
                        0, R - 1).long()
        return self.cells((i[:, 0] * R + i[:, 1]) * R + i[:, 2])[1]
