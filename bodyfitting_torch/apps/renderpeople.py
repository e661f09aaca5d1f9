"""The RenderPeople scan fitting app on one CUDA card.

Counterpart of ``bodyfitting_tpu/apps/renderpeople.py``: the same CLI
(every flag, the reference-compatibility one included), data layout,
caches and outputs.  For each textured OBJ scan under ``--target_dir``
(``_30k.obj`` decimations skipped): render ``--viewnum`` ring views of
the scan (cached as ``images/%02d.png`` and ``masks/%02d.png``), run the
OpenPose binary on them unless its JSONs are cached, fit SMPL(-X) to the
keypoints and the scan's distance volume with the optional SMPL+D
displacement stage (``smplify/``), fit a UV texture to renders of the
scan (``texfit/``), and copy the fit to ``SMPL/<subject>.{obj,npy}``.
The next scan's host prep (OBJ and texture reads, view renders, OpenPose)
runs on a thread while the current scan fits.

Scans and textures are read by the port's own readers (``io/obj.py``,
``io/jpeg.py``, ``io/png.py``); images are written as PNG.  With
``--debug`` the fitted-vs-scan ring views are written as PNG stills only
(``texfit/render/``): the card's machine has no video encoder.

Run:  python -m bodyfitting_torch.apps.renderpeople --target_dir ...
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bodyfitting_torch.apps.genebody import load_body_model, load_prior
from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting import body_fitting as bf
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.fitting import texture as texfit
from bodyfitting_torch.io import params as io_params
from bodyfitting_torch.io.images import (
    IMREAD_UNCHANGED,
    imread_checked,
    imwrite,
)
from bodyfitting_torch.io.obj import load_obj, save_obj_uv
from bodyfitting_torch.io.openpose import load_openpose_dir
from bodyfitting_torch.ops import rasterize as rz
from bodyfitting_torch.utils.observability import LossTrace


def config_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--target_dir", type=str, default="./data/renderpeople")
    p.add_argument("--output_dir", type=str, default="./logs_rp")
    p.add_argument("--openpose_dir", type=str, default="../openpose")
    p.add_argument("--info_dir", type=str, default=None)
    p.add_argument("--debug", default=False, action="store_true")
    p.add_argument("--timing", default=False, action="store_true",
                   help="print a per-stage wall-clock line per scan "
                        "(prep incl. renders+openpose / smplify incl. "
                        "smpld / texfit / output)")
    p.add_argument("--load_size", default=512, type=int)
    p.add_argument("--viewnum", default=8, type=int)
    p.add_argument("--tasks", nargs="+", type=str,
                   default=["openpose", "smplify", "smpld", "texfit",
                            "output"])
    p.add_argument("--use_mask", default=False, action="store_true")
    p.add_argument("--white_bkgd", default=True, action="store_true")
    p.add_argument("--smpl_type", default="smpl", type=str)
    p.add_argument("--age", default="adult", type=str)
    p.add_argument("--num_iters", default=600, type=int)
    p.add_argument("--contour_resample", default=512, type=int,
                   help="arc-length resample mask contours to this many "
                        "points (0 = keep every contour pixel)")
    p.add_argument("--smpl_uv_dir", type=str, default="./data/smpl_uv",
                   help="folder containing smpl_uv.obj / smplx_uv.obj")
    p.add_argument("--auto_uv", default=False, action="store_true",
                   help="generate a per-face chart atlas when the UV "
                        "template is absent (utils/uv_unwrap.py) instead "
                        "of skipping texture fitting")
    p.add_argument("--tex_iters", default=200, type=int)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--gmm_path", type=str, default=None)
    p.add_argument("--hmr_checkpoint", type=str, default=None)
    p.add_argument("--mean_params", type=str, default=None)
    p.add_argument("--synthetic_num_verts", type=int, default=None)
    p.add_argument("--inpaint", default=False, action="store_true",
                   help="inpaint unseen UV regions after texture fitting")
    p.add_argument("--lbam_checkpoint", type=str, default=None,
                   help="LBAM weights; diffusion inpainting when absent")
    p.add_argument("--disp_map", default=False, action="store_true",
                   help="also bake the SMPL+D displacement field into a "
                        "UV map (texfit/smpl_dis.png) — the output the "
                        "reference declares but ships disabled "
                        "(texture_fitting.py:303-307)")
    p.add_argument("--prep_scans", default=False, action="store_true",
                   help="normalise scans in place first: insert missing "
                        "MTL references (reference mtl_check)")
    # reference-CLI compatibility: declared by the reference but unused
    p.add_argument("--smplx_with_smpl_init", default=True,
                   action="store_true",
                   help="accepted for reference-CLI compatibility (unused, "
                        "as in the reference)")
    return p


def discover_scans(target_dir):
    """Every ``.obj`` scan under ``target_dir`` but the ``_30k.obj``
    decimations: ``(subjects, meshes)``, the subject being the scan's
    folder name."""
    subjects, meshes = [], []
    for path, _, files in os.walk(target_dir):
        for name in files:
            if name.endswith(".obj") and not name.endswith("_30k.obj"):
                meshes.append(os.path.join(path, name))
                subjects.append(os.path.basename(path))
    return subjects, meshes


class Runner:
    """The scans' runs.  ``device`` (default ``cuda``; raises without a
    card) is where the renders and fits run."""

    def __init__(self, args, device=None):
        self.args = args
        self.device = default_device(device)
        self.output_dir = args.output_dir
        self.use_hand_face = args.smpl_type == "smplx"
        self.subjects, self.meshfiles = discover_scans(args.target_dir)
        self.genders = self._genders()
        # per-gender models; self.model is re-pointed per scan in run()
        self._models = {}
        self.model = self._model_for(self.genders[0] if self.genders
                                     else "neutral")
        self.prior = load_prior(args, self.device)
        self.hmr = (bf.HMRBundle.load(args.hmr_checkpoint, args.mean_params,
                                      device=self.device)
                    if args.hmr_checkpoint else None)
        self.disp = "smpld" in args.tasks
        # subject -> wall seconds of each stage and of texfit's parts
        self.timings = {}
        self._parts = {}

    def _model_for(self, gender: str):
        if gender not in self._models:
            self._models[gender] = load_body_model(self.args, gender,
                                                   self.device)
        return self._models[gender]

    def _genders(self):
        """The ``--info_dir`` CSV's genders, row by row in scan order (its
        second column: 0 female, else male); neutral without the file."""
        if self.args.info_dir and os.path.exists(self.args.info_dir):
            with open(self.args.info_dir) as f:
                return ["female" if int(row[1]) == 0 else "male"
                        for row in csv.reader(f)]
        return ["neutral"] * len(self.subjects)

    def render_data(self, subject, meshfile):
        """The scan and its views: ``(scan, scan_face_uvs, images, masks,
        Ks, c2ws)``.  Views cached under ``images/`` and ``masks/`` are
        re-read; otherwise they are rendered and written there."""
        imgdir = os.path.join(self.output_dir, subject, "images")
        maskdir = os.path.join(self.output_dir, subject, "masks")
        os.makedirs(imgdir, exist_ok=True)
        os.makedirs(maskdir, exist_ok=True)
        if self.args.prep_scans:
            from bodyfitting_torch.io.scan_prep import ensure_mtl

            ensure_mtl(meshfile)
        scan = load_obj(meshfile, load_texture=True)
        if scan.face_uvs is None or scan.texture is None:
            raise ValueError(f"{meshfile} lacks UVs/texture")
        scan_face_uvs = scan.uvs[scan.face_uvs]
        n, size = self.args.viewnum, self.args.load_size
        if os.path.exists(os.path.join(imgdir, "00.png")):
            images = [imread_checked(os.path.join(imgdir, "%02d.png" % i))
                      [:, :, ::-1] for i in range(n)]
            masks = [imread_checked(os.path.join(maskdir, "%02d.png" % i),
                                    IMREAD_UNCHANGED) for i in range(n)]
            center, _, dist = texfit.scene_bounds(scan.verts)
            w2cs = texfit.ring_poses(center, n, dist)
            Ks = np.stack([texfit.default_K(size)] * n)
        else:
            images, masks, w2cs, Ks = texfit.render_scan_views(
                scan.verts, scan.faces, scan_face_uvs, scan.texture,
                imgsize=size, viewnum=n, white_bkgd=self.args.white_bkgd,
                device=self.device)
            for i in range(n):
                imwrite(os.path.join(imgdir, "%02d.png" % i), images[i])
                imwrite(os.path.join(maskdir, "%02d.png" % i), masks[i])
        c2ws = [np.linalg.inv(w2c).astype(np.float32) for w2c in w2cs]
        return scan, scan_face_uvs, list(images), list(masks), list(Ks), c2ws

    def run_openpose(self, subject, n_images):
        """The OpenPose binary on the scan's views, unless every view's
        JSON is cached."""
        img_dir = os.path.abspath(os.path.join(self.output_dir, subject,
                                               "images"))
        wrt_dir = os.path.abspath(os.path.join(self.output_dir, subject,
                                               "openpose"))
        os.makedirs(wrt_dir, exist_ok=True)
        n_json = len([f for f in os.listdir(wrt_dir) if f.endswith(".json")])
        if n_json >= n_images:
            return
        hand_face = ["--hand", "--face"] if self.use_hand_face else []
        cmd = ["build/examples/openpose/openpose.bin",
               "--image_dir", img_dir, "--write_json", wrt_dir,
               "--display", "0", "--render_pose", "0"] + hand_face
        subprocess.run(cmd, cwd=self.args.openpose_dir, check=True)

    def run_smplify(self, subject, scan, data, keypoints):
        """The scan fit (SMPLify with the point-to-scan term, then SMPL+D
        with ``smpld``); writes ``smplify/`` and the loss trace and
        returns the result as numpy."""
        _, _, images, masks, Ks, c2ws = data
        use_mask = self.args.use_mask
        obs = bf.build_observations(
            c2ws, Ks, keypoints, self.use_hand_face,
            masks=masks if use_mask else None,
            mask_c2ws=c2ws if use_mask else None,
            mask_Ks=Ks if use_mask else None,
            scan_verts=scan.verts, scan_faces=scan.faces,
            contour_resample=self.args.contour_resample or None,
            device=self.device)
        betas, poses = bf.hmr_init(images[0] if self.hmr else None, c2ws[0],
                                   self.hmr)
        init = bf.init_params_from_hmr(self.model, betas, poses)
        config = smplify.FitConfig(
            num_iters=self.args.num_iters, use_mask=use_mask, use_mesh=True,
            displacement=self.disp, imsize=float(self.args.load_size))
        _, result, losses = bf.fit_scan(self.model, config, obs, init,
                                        self.prior)
        result = {k: v.cpu().numpy() for k, v in result.items()}
        LossTrace(os.path.join(self.output_dir, "loss_trace.jsonl")).record(
            subject, losses.cpu().numpy())
        bf.save_frame_outputs(
            os.path.join(self.output_dir, subject, "smplify"),
            self.args.smpl_type, self.model, result, images=images,
            c2ws=c2ws, Ks=Ks, debug=self.args.debug)
        return result

    def _uv_template(self):
        """``(uvs, face_uvs)`` of the SMPL UV template, the ``--auto_uv``
        atlas when there is none, or ``None`` (texfit skipped)."""
        uv_path = os.path.join(self.args.smpl_uv_dir,
                               f"{self.args.smpl_type}_uv.obj")
        if os.path.exists(uv_path):
            uv_mesh = load_obj(uv_path)
            return uv_mesh.uvs, uv_mesh.face_uvs
        if self.args.auto_uv:
            from bodyfitting_torch.utils.uv_unwrap import per_face_atlas

            print(f"no UV template at {uv_path}; generating a per-face "
                  "chart atlas (--auto_uv)", file=sys.stderr)
            return per_face_atlas(len(self.model.faces))
        print(f"WARNING: no UV template at {uv_path}; skipping texfit "
              "(pass --auto_uv to generate one)", file=sys.stderr)
        return None

    def run_texfit(self, subject, scan, scan_face_uvs, result):
        """The UV texture fit of the SMPL(+D) mesh to renders of the scan,
        hole fill, optional inpainting; writes ``texfit/``."""
        template = self._uv_template()
        if template is None:
            return
        uvs, face_uvs = template
        dev = self.device
        faces = self.model.faces.cpu().numpy()
        smpl_face_uvs = uvs[face_uvs]
        verts = result["vertices"] + result.get(
            "displacement", np.zeros_like(result["vertices"]))
        cfg = texfit.TextureFitConfig(iter_num=self.args.tex_iters)
        t0 = time.perf_counter()
        tex, _ = texfit.fit_texture(
            verts, faces, smpl_face_uvs, scan.verts, scan.faces,
            scan_face_uvs, scan.texture, cfg, device=dev)
        tex = tex.cpu().numpy()
        t1 = time.perf_counter()
        uv_raster = texfit.rasterize_uv_atlas(smpl_face_uvs,
                                              cfg.tex_img_size, device=dev)
        coverage = rz.render_silhouette(uv_raster).cpu().numpy()
        img = texfit.fill_texture_holes(tex, coverage)
        if self.args.inpaint:
            # unseen texels stay near the grey init (the reference detects
            # 118-138/255 grey, texture_fitting.py:191-218)
            grey = np.abs(img - 128.0 / 255.0).max(-1) < 0.04
            unseen = grey & (coverage > 0.5)
            if self.args.lbam_checkpoint:
                from bodyfitting_torch.models.inpaint import Inpainter

                net = Inpainter(self.args.lbam_checkpoint, device=dev)
                img = net((img * 255).astype(np.uint8),
                          (unseen[..., None] * np.uint8(255)).repeat(3, -1))
            else:
                img = texfit.inpaint_unseen(img, unseen, device=dev)
        t2 = time.perf_counter()
        out_dir = os.path.join(self.output_dir, subject, "texfit")
        os.makedirs(out_dir, exist_ok=True)
        imwrite(os.path.join(out_dir, "smpl.png"),
                (np.clip(img, 0, 1) * 255).astype(np.uint8))
        save_obj_uv(os.path.join(out_dir,
                                 f"{self.args.smpl_type}+d_textured.obj"),
                    verts, faces, uvs, face_uvs, texture=img)
        if self.args.disp_map and "displacement" in result:
            # the reference declares this output but ships it disabled
            # (texture_fitting.py:303-307); here it works, opt-in
            dis_map, dis_cov = texfit.bake_displacement_map(
                smpl_face_uvs, faces, result["displacement"],
                cfg.tex_img_size, raster=uv_raster, device=dev)
            imwrite(os.path.join(out_dir, "smpl_dis.png"),
                    texfit.displacement_map_to8b(dis_map, dis_cov))
        t3 = time.perf_counter()
        if self.args.debug:
            texfit.render_compare(
                (verts, faces, smpl_face_uvs, img),
                (scan.verts, scan.faces, scan_face_uvs, scan.texture),
                os.path.join(out_dir, "render"), viewnum=36,
                imgsize=self.args.load_size, device=dev)
        self._parts[subject] = {
            "texfit/fit": t1 - t0, "texfit/atlas+fill+inpaint": t2 - t1,
            "texfit/writes": t3 - t2,
            "texfit/render_compare": time.perf_counter() - t3}

    def run_output(self, subject):
        """Copy the scan's fit to ``SMPL/<subject>.obj`` and ``.npy``."""
        smpl_folder = os.path.join(self.output_dir, "SMPL")
        os.makedirs(smpl_folder, exist_ok=True)
        fit_dir = os.path.join(self.output_dir, subject, "smplify")
        t = self.args.smpl_type
        for src, ext in ((f"{t}.obj", "obj"), (f"{t}_parameter.npy", "npy")):
            if os.path.exists(os.path.join(fit_dir, src)):
                shutil.copy(os.path.join(fit_dir, src),
                            os.path.join(smpl_folder, f"{subject}.{ext}"))

    def _load_cached_fit(self, subject):
        """The smplify stage's written parameter dict, or None."""
        param = os.path.join(self.output_dir, subject, "smplify",
                             io_params.param_filename(self.args.smpl_type))
        if not os.path.exists(param):
            return None
        return io_params.load_params(param)

    def _prepare_scan(self, subject, meshfile):
        """Host-side prep of one scan (OBJ and texture reads, the view
        renders or their cache, OpenPose), prefetched one scan ahead while
        the previous scan fits."""
        data = self.render_data(subject, meshfile)
        if "openpose" in self.args.tasks:
            self.run_openpose(subject, len(data[2]))
        keypoints = load_openpose_dir(os.path.join(self.output_dir, subject,
                                                   "openpose"))
        return data, keypoints

    def run(self):
        items = list(zip(self.subjects, self.meshfiles, self.genders))
        tasks = self.args.tasks
        with ThreadPoolExecutor(max_workers=1) as prep:
            fut = (prep.submit(self._prepare_scan, *items[0][:2])
                   if items else None)
            for i, (subject, meshfile, gender) in enumerate(items):
                t0 = time.perf_counter()
                self.model = self._model_for(gender)
                data, keypoints = fut.result()
                t_prep = time.perf_counter()
                if i + 1 < len(items):
                    fut = prep.submit(self._prepare_scan, *items[i + 1][:2])
                scan, scan_face_uvs = data[0], data[1]
                result = None
                if "smplify" in tasks:
                    result = self.run_smplify(subject, scan, data, keypoints)
                t_fit = time.perf_counter()
                if "texfit" in tasks:
                    if result is None:
                        # texfit without smplify in the same run reuses the
                        # written fit, as the reference loads its smpl+d
                        # outputs (texture_fitting.py:227-230)
                        result = self._load_cached_fit(subject)
                    if result is None:
                        print(f"WARNING: no cached smplify result for "
                              f"{subject}; run the smplify task first",
                              file=sys.stderr)
                    else:
                        self.run_texfit(subject, scan, scan_face_uvs, result)
                t_tex = time.perf_counter()
                if "output" in tasks:
                    self.run_output(subject)
                t_out = time.perf_counter()
                self.timings[subject] = {
                    "prep": t_prep - t0, "smplify+smpld": t_fit - t_prep,
                    "texfit": t_tex - t_fit, "output": t_out - t_tex,
                    **self._parts.pop(subject, {})}
                if self.args.timing:
                    print(f"[timing] {subject}: prep {t_prep - t0:.3f}s "
                          f"(overlapped for later scans), smplify+smpld "
                          f"{t_fit - t_prep:.3f}s, texfit "
                          f"{t_tex - t_fit:.3f}s, output "
                          f"{t_out - t_tex:.3f}s", file=sys.stderr)


def main(argv=None, device=None):
    """Parse ``argv`` and run; returns the :class:`Runner`.  ``device``
    (default ``cuda``; raises without a card) is a Python-level argument,
    not a flag: tests pass ``device="cpu"``."""
    args = config_parser().parse_args(argv)
    runner = Runner(args, device=device)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
