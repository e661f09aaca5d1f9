"""The benchmark's one input generator.

A cell's traffic is a file of parameters (``workloads/<cell>.json``);
these functions turn those parameters and ``--seed`` into the model and
prior files of a configuration and into a pool of units' raw inputs:
calibrated ring cameras, OpenPose keypoints, masks, scans, and each
frame's initial parameters.  Ground-truth bodies are posed by the plain
reference (``reference/body.py``), never by the program.  Numpy on the
host; the same seed gives the same files and the same pool.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from benchmark.reference import body

SMPLX_PARENTS = ([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                  16, 17, 18, 19, 15, 15, 15]
                 + [20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38]
                 + [21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52,
                    53])
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of one seed (any integer)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def body_surface(rows, cols, rng):
    """A closed UV sphere of ``rows x cols + 2`` vertices and ``2 cols
    rows`` faces, squashed into a 1.8 m body-like ellipsoid with a
    seeded wobble."""
    th = np.pi * np.arange(1, rows + 1) / (rows + 1)
    ph = 2 * np.pi * np.arange(cols) / cols
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                   -1).reshape(-1, 3)
    v = np.concatenate([[[0.0, 1.0, 0.0]], pts, [[0.0, -1.0, 0.0]]])
    v = v * [0.35, 0.9, 0.25]
    a, b = rng.uniform(0, 2 * np.pi, 2)
    v = v * (1 + 0.08 * np.sin(5 * v[:, 1] + a)
             + 0.05 * np.cos(4 * v[:, 0] + b))[:, None]

    def vid(r, c):
        return 1 + r * cols + c % cols

    f = []
    for c in range(cols):
        f += [[0, vid(0, c + 1), vid(0, c)],
              [len(v) - 1, vid(rows - 1, c), vid(rows - 1, c + 1)]]
        for r in range(rows - 1):
            f += [[vid(r, c), vid(r, c + 1), vid(r + 1, c)],
                  [vid(r, c + 1), vid(r + 1, c + 1), vid(r + 1, c)]]
    return v, np.asarray(f, np.int64)


def _rig(v, J, rng):
    """A joint regressor (each joint a peaked average of vertices) and
    skinning weights falling off with the distance to each joint."""
    reg = rng.random((J, len(v))) ** 8
    reg /= reg.sum(1, keepdims=True)
    d2 = ((v[:, None] - (reg @ v)[None]) ** 2).sum(-1)
    w = np.exp(-20.0 * d2)
    return reg, w / w.sum(1, keepdims=True)


def write_model(path, cfg, seed):
    """A seeded model file at the configuration's published widths, in
    the released ``.npz`` layout the program's ``load_model`` reads.
    ``cfg["model"]``: ``type``, ``num_verts``, ``num_faces``,
    ``num_joints``, ``shape_dirs_stored``, and the surface's ``rows`` x
    ``cols`` (SMPL: the closed mesh) or nothing (SMPL-X: random faces,
    which only the face landmarks read)."""
    m = cfg["model"]
    rng = rng_for(seed, 1)
    V, J = m["num_verts"], m["num_joints"]
    if "rows" in m:
        v, f = body_surface(m["rows"], m["cols"], rng)
    else:
        v, _ = body_surface(int(np.sqrt(V / 2)), V // int(np.sqrt(V / 2)), rng)
        v = np.concatenate([v, v[rng.integers(0, len(v), V - len(v))]])[:V]
        v = v + rng.normal(scale=0.004, size=v.shape)
        F = m["num_faces"]
        a = rng.integers(0, V, F)
        f = np.stack([a, (a + 1 + rng.integers(0, V - 1, F)) % V,
                      (a + 1 + rng.integers(0, V - 1, F)) % V], 1)
        f[:, 2] = np.where(f[:, 2] == f[:, 1], (f[:, 2] + 1) % V, f[:, 2])
        f[:, 2] = np.where(f[:, 2] == f[:, 0], (f[:, 2] + 1) % V, f[:, 2])
    assert len(v) == V and len(f) == m["num_faces"], (len(v), len(f))
    reg, w = _rig(v, J, rng)
    S = m["shape_dirs_stored"]
    sd = np.zeros((V, 3, S), np.float32)
    used = list(range(10)) + (list(range(300, 310)) if S > 300 else [])
    sd[..., used] = rng.normal(scale=0.01, size=(V, 3, len(used)))
    parents = np.asarray(SMPLX_PARENTS if J == 55 else SMPL_PARENTS)
    arrays = dict(
        v_template=v.astype(np.float32), shapedirs=sd,
        posedirs=rng.normal(scale=1e-3, size=(V, 3, (J - 1) * 9)).astype(
            np.float32),
        J_regressor=reg.astype(np.float32), weights=w.astype(np.float32),
        f=f.astype(np.int64), kintree_table=np.stack([parents, np.arange(J)]))
    if m["type"] == "smplx":
        lmk_pool = f[:256]
        arrays.update(
            hands_componentsl=rng.normal(scale=0.5, size=(45, 45)),
            hands_componentsr=rng.normal(scale=0.5, size=(45, 45)),
            hands_meanl=rng.normal(scale=0.05, size=45),
            hands_meanr=rng.normal(scale=0.05, size=45),
            lmk_faces_idx=rng.integers(0, len(lmk_pool), 51),
            lmk_bary_coords=rng.dirichlet(np.ones(3), 51),
            dynamic_lmk_faces_idx=rng.integers(0, len(lmk_pool), (79, 17)),
            dynamic_lmk_bary_coords=rng.dirichlet(np.ones(3), (79, 17)))
    np.savez(path, **arrays)


def write_gmm(path, seed, K=8, D=69):
    """A seeded, well-conditioned ``gmm_08.pkl``."""
    rng = rng_for(seed, 2)
    covs = [a @ a.T + 0.25 * np.eye(D)
            for a in rng.normal(scale=0.05, size=(K, D, D))]
    with open(path, "wb") as f:
        pickle.dump({"means": rng.normal(scale=0.3, size=(K, D)),
                     "covars": np.stack(covs),
                     "weights": rng.dirichlet(np.ones(K))}, f)


def ring_cameras(n, imsize, focal, dist):
    """``n`` camera-to-world matrices on a horizontal ring looking at the
    origin (OpenCV axes), and their intrinsics, float32."""
    c2ws, Ks = [], []
    for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(th), 0.0, dist * np.cos(th)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[:3, 3] = eye
        c2ws.append(c2w)
        Ks.append([[focal, 0, imsize / 2], [0, focal, imsize / 2], [0, 0, 1]])
    return np.asarray(c2ws, np.float32), np.asarray(Ks, np.float32)


def project(pts, c2w, K):
    w2c = np.linalg.inv(c2w.astype(np.float64))
    uv = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ K.astype(np.float64).T
    return uv[:, :2] / uv[:, 2:3]


def splat_mask(uv, imsize, dilate):
    """A filled silhouette of projected points."""
    from scipy import ndimage

    p = np.round(uv).astype(np.int64)
    ok = (p >= 0).all(1) & (p < imsize).all(1)
    m = np.zeros((imsize, imsize), bool)
    m[p[ok, 1], p[ok, 0]] = True
    m = ndimage.binary_fill_holes(ndimage.binary_dilation(m,
                                                          iterations=dilate))
    return m.astype(np.float32)


def ground_truth(model, n, t, rng):
    """``n`` seeded poses of ``model`` (a reference ``body.Model``): the
    parameter dict, vertices and joints, float64."""
    nb = 3 * model.num_body_joints
    orient = np.zeros((n, 3))
    orient[:, 0] = t["orient_x"]
    orient[:, 1] = rng.uniform(-t["yaw"], t["yaw"], n)
    p = dict(betas=rng.normal(scale=t["betas_scale"], size=(n, 10)),
             global_orient=orient,
             body_pose=rng.normal(scale=t["pose_scale"], size=(n, nb)))
    if model.kind == "smplx":
        p.update(expression=np.zeros((n, 10)), jaw_pose=np.zeros((n, 3)),
                 leye_pose=np.zeros((n, 3)), reye_pose=np.zeros((n, 3)),
                 left_hand_pose=np.zeros((n, 6)),
                 right_hand_pose=np.zeros((n, 6)))
    with torch.no_grad():
        v, j = body.forward(model, {k: torch.as_tensor(a, dtype=torch.float64)
                                    for k, a in p.items()})
    return p, v.numpy(), j.numpy()


def initial_params(gt, noise, rng, keep_pose):
    """A fit's start for each ground truth: its orientation (and, with
    ``keep_pose``, its pose) plus seeded noise of scale ``noise`` (rad),
    zero shape, every other pose zero: a stand-in for the HMR keyframe
    initialisation the apps give the fit."""
    n = len(gt["body_pose"])
    pose = gt["body_pose"] if keep_pose else np.zeros_like(gt["body_pose"])
    return dict(
        global_orient=(gt["global_orient"]
                       + rng.normal(scale=noise, size=(n, 3))).astype(
            np.float32),
        body_pose=(pose + rng.normal(scale=noise, size=pose.shape)).astype(
            np.float32))


def mask_frames(model, cfg, t, seed):
    """The pool of a multi-view fit: ``t["pool_units"]`` units of
    ``t["frames_per_unit"]`` frames, each frame a dict of keypoints
    ``[views, 135, 3]`` (model joint order), masks, and initial
    parameters; the shared cameras; and the crop shape that holds every
    pool frame's silhouettes (12.5 % slack, rounded up to 8 x 128).  A
    fit without masks (``cfg["fit"]["use_mask"]`` false) gets none and
    no crop shape; its keypoints and starts are those of the same seed
    with masks."""
    rig = cfg["rig"]
    rng = rng_for(seed, 3)
    n = t["pool_units"] * t["frames_per_unit"]
    gt, verts, joints = ground_truth(model, n, t, rng)
    shift = rng.normal(scale=t["transl_scale"], size=(n, 1, 3))
    scale = rig["scene_scale"] * t["gt_scale"]
    verts, joints = (verts + shift) * scale, (joints + shift) * scale
    c2ws, Ks = ring_cameras(rig["views"], rig["imsize"], rig["focal"],
                            rig["dist"])
    step = rig["views"] // rig["mask_views"]
    mask_ids = list(range(0, rig["views"], step))[:rig["mask_views"]]
    init = initial_params(gt, t["init_noise"], rng, keep_pose=True)
    frames = []
    for f in range(n):
        kp = np.stack([project(joints[f], c, k) for c, k in zip(c2ws, Ks)])
        kp = kp + rng.normal(scale=t["keypoint_noise_px"], size=kp.shape)
        kp = np.concatenate([kp, np.ones(kp.shape[:2] + (1,))], -1)
        masks = [splat_mask(project(verts[f, ::4], c2ws[i], Ks[i]),
                            rig["imsize"], t["splat_dilate"])
                 for i in mask_ids] if cfg["fit"].get("use_mask") else []
        frames.append(dict(keypoints=kp.astype(np.float32), masks=masks,
                           init={k: a[f] for k, a in init.items()}))
    if not cfg["fit"].get("use_mask"):
        return dict(frames=frames, c2ws=c2ws, Ks=Ks, mask_ids=[],
                    crop_hw=None)
    hw = np.zeros(2, np.int64)
    for fr in frames:
        for m in fr["masks"]:
            ys, xs = np.nonzero(m)
            hw = np.maximum(hw, [np.ptp(ys) + 5, np.ptp(xs) + 5])
    crop_hw = (min(rig["imsize"], -(-int(hw[0] * 1.125) // 8) * 8),
               min(rig["imsize"], -(-int(hw[1] * 1.125) // 128) * 128))
    return dict(frames=frames, c2ws=c2ws, Ks=Ks, mask_ids=mask_ids,
                crop_hw=crop_hw)


def subdivide(v, f):
    """Midpoint subdivision, each triangle into four."""
    F = len(f)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), 1)
    uniq, inv = np.unique(e, axis=0, return_inverse=True)
    mid = len(v) + inv.reshape(3, F).T
    v = np.concatenate([v, 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])])
    a, b, c = f.T
    m01, m12, m20 = mid.T
    return v, np.concatenate([np.stack([a, m01, m20], 1),
                              np.stack([m01, b, m12], 1),
                              np.stack([m20, m12, c], 1),
                              np.stack([m01, m12, m20], 1)]).astype(np.int64)


def vertex_normals(v, f):
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)


def scans(model, cfg, t, seed):
    """The pool of a scan fit: ``t["pool_units"]`` scans, each the posed
    ground truth subdivided ``t["subdivisions"]`` times and pushed out
    5-15 mm along its normals (clothing), seen by the rig's ring of
    views at ``imsize``², focal ``imsize``, distance height / 0.8 (as the
    RenderPeople app renders a scan), with BODY_25 keypoints at 1 px of
    noise and an initial pose."""
    rig = cfg["rig"]
    rng = rng_for(seed, 4)
    n = t["pool_units"]
    gt, verts, joints = ground_truth(model, n, t, rng)
    init = initial_params(gt, t["init_noise"], rng, keep_pose=False)
    faces = model.faces.numpy()
    out = []
    for i in range(n):
        v, f = verts[i], faces
        for _ in range(t["subdivisions"]):
            v, f = subdivide(v, f)
        off = 0.010 + 0.005 * np.sin(7.0 * v[:, 1] + rng.uniform(0, 6)) \
            * np.cos(5.0 * v[:, 0] + 3.0 * v[:, 2])
        sv = (v + off[:, None] * vertex_normals(v, f)).astype(np.float32)
        height = float(np.ptp(sv[:, 1]))
        c2ws, Ks = ring_cameras(rig["views"], rig["imsize"],
                                float(rig["imsize"]), height / 0.8)
        kp = np.stack([project(joints[i, :25], c, k)
                       for c, k in zip(c2ws, Ks)])
        kp = kp + rng.normal(scale=t["keypoint_noise_px"], size=kp.shape)
        kp = np.concatenate([kp, np.ones(kp.shape[:2] + (1,))], -1)
        out.append(dict(scan_verts=sv, scan_faces=f, c2ws=c2ws, Ks=Ks,
                        keypoints=kp.astype(np.float32),
                        init={k: a[i] for k, a in init.items()}))
    return out
