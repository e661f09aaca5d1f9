"""The GeneBody mocap fitting app on one CUDA card.

Counterpart of ``bodyfitting_tpu/apps/genebody.py``: the same CLI (every
flag, the reference-compatibility rows included), data layout, caches and
outputs — ``--tasks openpose smplify output``, per-frame ``images/`` and
``openpose/`` caches, the bbox and mask-crop caches, the final
``smpl/%04d.obj`` and ``param/%04d.npy`` — with frames fitted in batches
(``--batch_frames``) through one staged optimisation.  The pipelined loop
prepares upcoming frames on host threads while the card fits the current
batch: prep threads build each frame's observations on the host and run
HMR on a stream of their own, and the fit copies a batch to the card on
its stream just before it starts.

Not ported, and refused with an error: ``--data_parallel`` (ROADMAP §1
item 6) and ``--native_openpose`` (item 4).  Images are PNG or JPEG,
decoded by the port's own readers (``io/png.py``, ``io/jpeg.py``): the
card's machine has no image library.

Run:  python -m bodyfitting_torch.apps.genebody --target_dir ... --subject ...
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bodyfitting_torch import constants
from bodyfitting_torch.device import default_device
from bodyfitting_torch.fitting import body_fitting as bf
from bodyfitting_torch.fitting import smplify
from bodyfitting_torch.io.cameras import genebody_views, load_annots
from bodyfitting_torch.io.images import (
    IMREAD_UNCHANGED,
    adjust_K_for_crop,
    apply_mask,
    crop_and_resize,
    imread_checked,
    imwrite,
    mask_square_bbox,
)
from bodyfitting_torch.io.openpose import load_openpose_dir
from bodyfitting_torch.losses import priors
from bodyfitting_torch.losses.silhouette import compute_mask_crops
from bodyfitting_torch.models import body_model as bm
from bodyfitting_torch.utils.observability import LossTrace, StageTimer


def config_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--target_dir", type=str, default="/data/genebody")
    p.add_argument("--annot_dir", type=str, default=None,
                   help="annots.npy with camera parameters")
    p.add_argument("--output_dir", type=str, default="./logs")
    p.add_argument("--native_openpose", default=False, action="store_true",
                   help="the in-repo detector; not ported (raises)")
    p.add_argument("--openpose_ckpt_dir", type=str, default=None,
                   help="checkpoints of the native detector (with "
                        "--native_openpose; not ported)")
    p.add_argument("--openpose_dir", type=str, default="../openpose",
                   help="directory of the built openpose binary")
    p.add_argument("--info_dir", type=str, default=None,
                   help="csv with per-subject gender")
    p.add_argument("--debug", default=False, action="store_true")
    p.add_argument("--subject", type=str, default="zhuna")
    p.add_argument("--load_size", default=512, type=int)
    p.add_argument("--tasks", nargs="+", type=str,
                   default=["openpose", "smplify", "output"])
    p.add_argument("--use_mask", default=False, action="store_true")
    p.add_argument("--smpl_type", default="smpl", type=str)
    p.add_argument("--age", default="adult", type=str)
    p.add_argument("--num_iters", default=600, type=int)
    p.add_argument("--mask_crop", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="run the stay-inside mask term on content-cropped "
                        "masks (exact values; the crop shape is derived "
                        "from the subject's first batch and grown on "
                        "demand)")
    p.add_argument("--contour_resample", default=512, type=int,
                   help="arc-length resample mask contours to this many "
                        "points (0 = keep every contour pixel)")
    p.add_argument("--batch_frames", default=8, type=int,
                   help="frames fitted together in one optimisation")
    p.add_argument("--prep_workers", default=2, type=int,
                   help="host threads preparing upcoming frames while the "
                        "card fits the current batch; 0 = fully serial")
    p.add_argument("--io_cache", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="persist per-frame crop bboxes and cropped GT-view "
                        "masks under output_dir so later runs skip the "
                        "full-resolution mask decodes (identical results)")
    p.add_argument("--data_parallel", default=False, action="store_true",
                   help="shard frame batches over several devices; not "
                        "ported (raises)")
    p.add_argument("--temporal", default=False, action="store_true",
                   help="temporally coupled fit per batch (velocity and "
                        "betas-consistency priors over the frame axis; "
                        "fitting/sequence.py)")
    p.add_argument("--timing", default=False, action="store_true",
                   help="accumulate per-stage wall times; summary printed "
                        "at the end and written to <output_dir>/timing.json")
    p.add_argument("--model_path", type=str, default=None,
                   help="SMPL pkl / SMPL-X npz asset; synthetic when absent")
    p.add_argument("--gmm_path", type=str, default=None,
                   help="gmm_08.pkl pose prior; synthetic when absent")
    p.add_argument("--hmr_checkpoint", type=str, default=None)
    p.add_argument("--mean_params", type=str, default=None)
    p.add_argument("--synthetic_num_verts", type=int, default=None,
                   help="vertex count of the synthetic fallback model "
                        "(tiny values for smoke tests)")
    p.add_argument("--smplx_with_smpl_init", default=False,
                   action="store_true",
                   help="seed the SMPL-X fit from a first SMPL fit")
    # reference-CLI compatibility: declared by the reference but unused
    p.add_argument("--use_bodyscan", default=False, action="store_true",
                   help="accepted for reference-CLI compatibility (unused)")
    p.add_argument("--viewnum", type=int, default=8,
                   help="accepted for reference-CLI compatibility (unused)")
    p.add_argument("--smpl_uv_dir", type=str, default="./data/smpl_uv",
                   help="accepted for reference-CLI compatibility (unused)")
    p.add_argument("--white_bkgd", default=True, action="store_true",
                   help="accepted for reference-CLI compatibility (unused)")
    return p


def resolve_model_path(model_path: str, smpl_type: str, gender: str) -> str:
    """The asset file for ``gender``: a directory resolves to
    ``<dir>/<TYPE>_<GENDER>.<ext>``; a file path has its gender token
    replaced when such a sibling exists, else is used as it is."""
    genders = (gender.upper(), gender.lower())
    if os.path.isdir(model_path):
        for g in genders:
            for ext in (".npz", ".pkl"):
                cand = os.path.join(model_path,
                                    f"{smpl_type.upper()}_{g}{ext}")
                if os.path.exists(cand):
                    return cand
        raise FileNotFoundError(f"no {smpl_type.upper()}_{gender.upper()}"
                                f".npz/.pkl under {model_path}")
    base = os.path.basename(model_path)
    for tok in ("NEUTRAL", "MALE", "FEMALE", "neutral", "male", "female"):
        if tok in base:
            for g in genders:
                cand = os.path.join(os.path.dirname(model_path),
                                    base.replace(tok, g))
                if os.path.exists(cand):
                    return cand
            break
    return model_path


# Models and priors are shared by Runners of one process that ask for the
# same files on the same device.
_MODEL_CACHE: dict = {}
_PRIOR_CACHE: dict = {}


def load_body_model(args, gender: str = "neutral", device=None):
    device = default_device(device)
    key = (args.model_path, args.smpl_type, gender,
           getattr(args, "synthetic_num_verts", None), str(device))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = _load_body_model_uncached(args, gender, device)
    return _MODEL_CACHE[key]


def _load_body_model_uncached(args, gender, device):
    if args.model_path and os.path.exists(args.model_path):
        path = resolve_model_path(args.model_path, args.smpl_type, gender)
        if gender != "neutral" and path == args.model_path and \
                not os.path.isdir(args.model_path):
            print(f"WARNING: no {gender} variant of {args.model_path} "
                  "found; fitting with the given model", file=sys.stderr)
        model = bm.load_model(path, model_type=args.smpl_type, device=device)
    else:
        print("WARNING: no --model_path given; using a synthetic body model "
              "(fits run, outputs are not anthropometric)", file=sys.stderr)
        nv = getattr(args, "synthetic_num_verts", None) or (
            constants.SMPLX_NUM_VERTS if args.smpl_type == "smplx"
            else constants.SMPL_NUM_VERTS)
        model = bm.synthetic_model(args.smpl_type, num_verts=nv,
                                   device=device)
    if model.model_type == "smpl":
        model = bm.spin_joint_mapper_for_smpl(model)
    return model


def load_prior(args, device=None):
    device = default_device(device)
    key = (args.gmm_path, str(device))
    if key not in _PRIOR_CACHE:
        if args.gmm_path and os.path.exists(args.gmm_path):
            prior = priors.load_gmm_prior(args.gmm_path, device=device)
        else:
            prior = priors.synthetic_gmm_prior(device=device)
        _PRIOR_CACHE[key] = prior
    return _PRIOR_CACHE[key]


class Runner:
    """One subject's run.  ``device`` (default ``cuda``; raises without a
    card) is where the fits run; frames are prepared on the host."""

    def __init__(self, args, device=None):
        if args.data_parallel:
            raise NotImplementedError(
                "--data_parallel (frame batches sharded over several "
                "devices) is not ported yet: ROADMAP §1 item 6")
        if args.native_openpose:
            raise NotImplementedError(
                "--native_openpose (the in-repo detector) is not ported "
                "yet: ROADMAP §1 item 4; run the openpose binary or "
                "provide the keypoint JSONs")
        self.args = args
        self.device = default_device(device)
        self.subject = args.subject
        self.target_dir = os.path.join(args.target_dir, self.subject)
        self.output_dir = os.path.join(args.output_dir, self.subject)
        annot = (os.path.join(args.annot_dir, self.subject + ".npy")
                 if args.annot_dir
                 else os.path.join(self.target_dir, "annots.npy"))
        self.Ks_all, self.RTs_all = load_annots(annot)
        self.views = genebody_views(self.subject)
        self.mask_frames = list(constants.GENEBODY_MASK_FRAMES)
        self.gender = self._gender()
        self.use_hand_face = args.smpl_type == "smplx"
        self.model = load_body_model(args, self.gender, self.device)
        self.prior = load_prior(args, self.device)
        self.hmr = (bf.HMRBundle.load(args.hmr_checkpoint, args.mean_params,
                                      device=self.device)
                    if args.hmr_checkpoint else None)
        # HMR runs on prep threads: on a stream of its own, off the fit's
        self._hmr_stream = None
        if self.hmr is not None and self.device.type == "cuda":
            self._hmr_stream = torch.cuda.Stream(self.device)
            # after the weights' uploads on the current stream
            self._hmr_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        self.seqs = self._sequence()
        self._debug_data = {}   # frame -> (images, c2ws, Ks, view ids)
        self._smpl_stage_model = None
        self._crop_lock = threading.Lock()
        self._crop_hw = None
        self.timer = StageTimer() if args.timing else None

    def _stage(self, name):
        return (self.timer.stage(name) if self.timer
                else contextlib.nullcontext())

    def _gender(self):
        if self.args.info_dir and os.path.exists(self.args.info_dir):
            with open(self.args.info_dir) as f:
                for row in csv.reader(f):
                    if row and row[0] == self.subject:
                        return "female" if int(row[1]) == 0 else "male"
        return "neutral"

    def _sequence(self):
        names = sorted(os.listdir(os.path.join(self.target_dir, "image",
                                               "00")))
        return [int(os.path.splitext(n)[0]) for n in names]

    # ----- per-frame data preparation (host) ------------------------------

    def get_data(self, frame):
        """Read and crop the frame's views (threaded), with the bbox and
        mask-crop caches: ``(images, masks, Ks, c2ws, use_frames,
        mask_frames)``.  Cache rows are ``(status, top, left, bottom,
        right)``, status 0 not cached, 1 bbox valid, 2 view unusable."""
        size = self.args.load_size
        frame_dir = os.path.join(self.output_dir, "%06d" % frame)
        img_dir = os.path.join(frame_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        op_dir = os.path.join(frame_dir, "openpose")
        imgnames = sorted(os.listdir(os.path.join(self.target_dir, "image",
                                                  "00")))
        msknames = sorted(os.listdir(os.path.join(self.target_dir, "mask",
                                                  "00")))
        frame_idx = self.seqs.index(frame)
        hmr_view = None
        if self.hmr is not None:
            hmr_view = (constants.GENEBODY_KEYFRAME
                        if constants.GENEBODY_KEYFRAME in self.views
                        else self.views[0])

        cache_path = os.path.join(frame_dir, "bbox_cache.npy")
        bbox_cache = None
        if self.args.io_cache and os.path.exists(cache_path):
            c = np.load(cache_path)
            if c.shape == (48, 5):
                bbox_cache = c.astype(np.int64)
        new_cache = (np.zeros((48, 5), np.int64) if bbox_cache is None
                     else bbox_cache.copy())
        crop_path = os.path.join(frame_dir, "mask_crops_%d.npz" % size)
        crop_cache = None
        if self.args.io_cache and os.path.exists(crop_path):
            with np.load(crop_path) as z:
                crop_cache = {int(k[1:]): z[k] for k in z.files}
        new_crops: dict = {}

        def load_view(i, view):
            cached = (bbox_cache[view]
                      if bbox_cache is not None and view < 48 else None)
            json_cached = os.path.exists(
                os.path.join(op_dir, "%02d_keypoints.json" % view))
            want_crop = view in self.mask_frames and self.args.use_mask
            cached_crop = (crop_cache.get(view)
                           if crop_cache is not None and view < 48 else None)
            need_img = (not json_cached or view == hmr_view
                        or self.args.debug)
            need_mask = (cached is None or cached[0] == 0
                         or (want_crop and cached_crop is None) or need_img)
            if cached is not None and cached[0] == 2:
                return None                 # cached empty-mask verdict
            if need_mask:
                msk = imread_checked(os.path.join(
                    self.target_dir, "mask", "%02d" % view,
                    msknames[frame_idx]), IMREAD_UNCHANGED)
                if msk.ndim == 3:
                    msk = msk[..., 0]
                if not msk.any():           # empty mask: view unusable
                    if view < 48:
                        new_cache[view] = (2, 0, 0, 0, 0)
                    return None
                bbox = mask_square_bbox(msk)
                if view < 48:
                    new_cache[view] = (1,) + tuple(bbox)
            else:
                msk = None
                bbox = tuple(int(v) for v in cached[1:])
            img = None
            if need_img:
                img = imread_checked(os.path.join(
                    self.target_dir, "image", "%02d" % view,
                    imgnames[frame_idx]))[:, :, ::-1]      # BGR -> RGB
                img = crop_and_resize(apply_mask(img, msk), bbox, size)
                if np.mean(img) <= 10:      # black frame: view unusable
                    return None
                if not json_cached:         # the OpenPose binary's input
                    imwrite(os.path.join(img_dir, "%02d.png" % view), img)
            crop_msk = None
            if want_crop:
                if msk is not None:
                    crop_msk = crop_and_resize(msk, bbox, size)
                    if view < 48:
                        new_crops[view] = crop_msk
                else:
                    crop_msk = cached_crop
            return (img, crop_msk,
                    adjust_K_for_crop(self.Ks_all[i], bbox, size),
                    self.RTs_all[i].astype(np.float32))

        with ThreadPoolExecutor(max_workers=min(16, len(self.views))) as ex:
            loaded = list(ex.map(load_view, range(len(self.views)),
                                 self.views))

        if self.args.io_cache and not np.array_equal(
                new_cache, bbox_cache if bbox_cache is not None else -1):
            np.save(cache_path, new_cache)
        if self.args.io_cache and any(
                crop_cache is None or v not in crop_cache
                or not np.array_equal(crop_cache[v], a)
                for v, a in new_crops.items()):
            merged = dict(crop_cache or {})
            merged.update(new_crops)
            np.savez(crop_path, **{"m%02d" % v: a for v, a in merged.items()})

        Ks, c2ws, use_frames, mask_frames, images, masks = (
            [], [], [], [], [], [])
        for view, item in zip(self.views, loaded):
            if item is None:
                continue
            img, crop_msk, K, c2w = item
            use_frames.append(view)
            images.append(img)
            if crop_msk is not None:
                masks.append(crop_msk)
                mask_frames.append(view)
            Ks.append(K)
            c2ws.append(c2w)
        return images, masks, Ks, c2ws, use_frames, mask_frames

    # ----- openpose subprocess (the reference's boundary) -----------------

    def run_openpose(self, frame, data):
        img_dir = os.path.abspath(os.path.join(self.output_dir, "%06d" % frame,
                                               "images"))
        wrt_dir = os.path.abspath(os.path.join(self.output_dir, "%06d" % frame,
                                               "openpose"))
        os.makedirs(wrt_dir, exist_ok=True)
        n_json = len([f for f in os.listdir(wrt_dir) if f.endswith(".json")])
        if n_json >= len(data[0]):
            return                          # cached
        hand_face = ["--hand", "--face"] if self.use_hand_face else []
        cmd = ["build/examples/openpose/openpose.bin",
               "--image_dir", img_dir, "--write_json", wrt_dir,
               "--display", "0", "--render_pose", "0"] + hand_face
        subprocess.run(cmd, cwd=self.args.openpose_dir, check=True)

    def _mask_crop_hw(self, masks):
        """The crop shape shared by the subject's frames: the first
        batch's content boxes with 12.5 % slack, rounded up to (8, 128)
        multiples, grown when a later frame's silhouette exceeds it
        (crops are value-exact, so growth changes no result)."""
        with self._crop_lock:
            if not masks:
                return self._crop_hw or (8, 128)
            _, _, (h, w) = compute_mask_crops(list(masks))
            full = int(self.args.load_size)
            cur = self._crop_hw
            if cur is None or h > cur[0] or w > cur[1]:
                def grow(v, q):
                    return min(full, -(-int(v * 1.125) // q) * q)

                new = (max(grow(h, 8), cur[0] if cur else 0),
                       max(grow(w, 128), cur[1] if cur else 0))
                if cur is not None:
                    print(f"[mask_crop] growing crop {cur} -> {new}",
                          flush=True)
                self._crop_hw = new
            return self._crop_hw

    def read_openpose(self, frame):
        return load_openpose_dir(os.path.join(self.output_dir, "%06d" % frame,
                                              "openpose"))

    # ----- batched fitting -------------------------------------------------

    def build_frame_inputs(self, frame, data, keypoints):
        """The frame's ``(Observations, FitParams)`` on the host (the fit
        copies its batch to the card), HMR on the keyframe."""
        images, masks, Ks, c2ws, use_frames, mask_frames = data
        use_mask = self.args.use_mask
        obs = bf.build_observations(
            c2ws, Ks, keypoints, self.use_hand_face,
            masks=masks if use_mask else None,
            mask_c2ws=([c2ws[use_frames.index(f)] for f in mask_frames]
                       if masks else None),
            mask_Ks=([Ks[use_frames.index(f)] for f in mask_frames]
                     if masks else None),
            num_views=len(self.views),
            mask_num_views=len(self.mask_frames),
            mask_imsize=self.args.load_size,
            contour_pad=8 * self.args.load_size,
            contour_resample=self.args.contour_resample or None,
            mask_crop=use_mask and self.args.mask_crop,
            mask_crop_hw=(self._mask_crop_hw(masks)
                          if use_mask and self.args.mask_crop else None),
            device="cpu",
        )
        keyframe = (constants.GENEBODY_KEYFRAME
                    if constants.GENEBODY_KEYFRAME in use_frames
                    else use_frames[0])
        key_idx = use_frames.index(keyframe)
        betas, poses = bf.hmr_init(images[key_idx] if self.hmr else None,
                                   c2ws[key_idx], self.hmr,
                                   stream=self._hmr_stream)
        init = bf.init_params_from_hmr(self.model, betas, poses,
                                       device="cpu")
        if self.args.debug:
            sel = [i for i in range(0, len(images), 12)
                   if images[i] is not None]
            self._debug_data[frame] = (
                [images[i] for i in sel], [c2ws[i] for i in sel],
                [Ks[i] for i in sel], [use_frames[i] for i in sel])
        return obs, init

    def _smpl_init_stage(self, obs_list, init_list, config):
        """Two-stage init: fit SMPL on the body keypoints, seed SMPL-X."""
        if self._smpl_stage_model is None:
            smpl_args = argparse.Namespace(**vars(self.args))
            smpl_args.smpl_type = "smpl"
            self._smpl_stage_model = load_body_model(smpl_args,
                                                     device=self.device)
        smpl_model = self._smpl_stage_model
        smpl_obs = [dataclasses.replace(o, keypoints=o.keypoints[:, :, :25])
                    for o in obs_list]
        smpl_inits = [
            bf.init_params_from_hmr(
                smpl_model, i.body.betas[0].cpu().numpy(),
                np.concatenate([i.body.global_orient[0].cpu().numpy(),
                                np.zeros(69, np.float32)]))
            for i in init_list
        ]
        _, res, _ = bf.fit_frames_batched(
            smpl_model, dataclasses.replace(config, use_mask=False),
            smpl_obs, smpl_inits, self.prior)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        return [bf.smplx_init_from_smpl(
                    self.model, {k: v[i] for k, v in res.items()})
                for i in range(len(obs_list))]

    @staticmethod
    def _harmonize_mask_crops(obs_list):
        """Zero-pad per-frame mask crops to one batch shape (value-exact:
        zero-padded bilinear sampling reads 0 outside the window)."""
        shapes = {tuple(o.mask_crops.shape[2:]) for o in obs_list
                  if o.mask_crops is not None}
        if len(shapes) <= 1:
            return obs_list
        Hc = max(h for h, _ in shapes)
        Wc = max(w for _, w in shapes)
        out = []
        for o in obs_list:
            if o.mask_crops is None or o.mask_crops.shape[2:] == (Hc, Wc):
                out.append(o)
                continue
            h, w = o.mask_crops.shape[2:]
            out.append(dataclasses.replace(o, mask_crops=torch.nn.functional.pad(
                o.mask_crops, (0, Wc - w, 0, Hc - h))))
        return out

    def dispatch_fit(self, frames, inputs):
        """Fit one batch on the card; returns the result tensors and the
        losses without waiting for the card."""
        config = smplify.FitConfig(
            num_iters=self.args.num_iters,
            use_mask=self.args.use_mask and any(
                o.masks is not None or o.mask_crops is not None
                for o, _ in inputs),
            imsize=float(self.args.load_size),
        )
        obs_list = self._harmonize_mask_crops([o for o, _ in inputs])
        obs_list = [smplify.to_device(o, self.device) for o in obs_list]
        init_list = [smplify.to_device(i, self.device) for _, i in inputs]
        if self.args.smplx_with_smpl_init and self.args.smpl_type == "smplx":
            init_list = self._smpl_init_stage(obs_list, init_list, config)
        with self._stage("fit/dispatch"):
            if self.args.temporal:
                results, losses = bf.fit_sequence_batched(
                    self.model, config, obs_list, init_list, self.prior)
            else:
                _, results, losses = bf.fit_frames_batched(
                    self.model, config, obs_list, init_list, self.prior)
        return results, losses

    def write_batch(self, frames, results, losses):
        """Fetch a batch's results and write its files (the writer thread
        in the pipelined loop)."""
        trace = LossTrace(os.path.join(self.output_dir, "loss_trace.jsonl"))
        with self._stage("fit/device_wait"):
            losses_np = losses.cpu().numpy()
            results = {k: v.cpu().numpy() for k, v in results.items()}
        with self._stage("write/outputs"):
            for bi, frame in enumerate(frames):
                # a temporal fit's curve is the sequence's: every frame
                # of the batch records it
                trace.record(int(frame), losses_np if losses_np.ndim == 1
                             else losses_np[bi])
                dbg = self._debug_data.pop(frame, None)
                bf.save_frame_outputs(
                    os.path.join(self.output_dir, "%06d" % frame, "smplify"),
                    self.args.smpl_type, self.model,
                    {k: v[bi] for k, v in results.items()},
                    images=dbg[0] if dbg else None,
                    c2ws=dbg[1] if dbg else None,
                    Ks=dbg[2] if dbg else None,
                    use_frames=dbg[3] if dbg else None,
                    render_skip=1, debug=dbg is not None)

    def fit_batch(self, frames, inputs):
        results, losses = self.dispatch_fit(frames, inputs)
        self.write_batch(frames, results, losses)

    def run_output(self, frame):
        frame_dir = os.path.join(self.output_dir, "%06d" % frame, "smplify")
        smpl_folder = os.path.join(self.output_dir, "smpl")
        param_folder = os.path.join(self.output_dir, "param")
        os.makedirs(smpl_folder, exist_ok=True)
        os.makedirs(param_folder, exist_ok=True)
        t = self.args.smpl_type
        shutil.copy(os.path.join(frame_dir, f"{t}.obj"),
                    os.path.join(smpl_folder, "%04d.obj" % frame))
        shutil.copy(os.path.join(frame_dir, f"{t}_parameter.npy"),
                    os.path.join(param_folder, "%04d.npy" % frame))

    def _prepare_frame(self, frame):
        """Host-side prep of one frame: image IO and crops, keypoint
        detection, observation assembly (and HMR on its own stream)."""
        with self._stage("prep/images"):
            data = self.get_data(frame)
        if "openpose" in self.args.tasks:
            with self._stage("prep/openpose"):
                self.run_openpose(frame, data)
        if "smplify" not in self.args.tasks:
            return None
        with self._stage("prep/observations"):
            return self.build_frame_inputs(frame, data,
                                           self.read_openpose(frame))

    def run(self):
        if self.args.prep_workers <= 0:
            self._run_serial()
        else:
            self._run_pipelined()
        if "output" in self.args.tasks:
            for frame in self.seqs:
                if os.path.exists(os.path.join(
                        self.output_dir, "%06d" % frame, "smplify",
                        f"{self.args.smpl_type}.obj")):
                    self.run_output(frame)
        if self.timer is not None:
            print("[timing] " + json.dumps(self.timer.summary()),
                  file=sys.stderr)
            self.timer.dump(os.path.join(self.output_dir, "timing.json"))

    def _run_serial(self):
        """Prep, fit, write: one batch at a time."""
        pending_frames, pending_inputs = [], []
        for frame in self.seqs:
            inputs = self._prepare_frame(frame)
            if inputs is None:
                continue
            pending_frames.append(frame)
            pending_inputs.append(inputs)
            if len(pending_frames) == self.args.batch_frames:
                self.fit_batch(pending_frames, pending_inputs)
                pending_frames, pending_inputs = [], []
        if pending_frames:
            self.fit_batch(pending_frames, pending_inputs)

    def _run_pipelined(self):
        """Prep threads read and crop upcoming frames while the card fits
        the current batch, and a writer thread drains finished batches to
        disk.  Outputs equal the serial loop's: frames enter batches in
        sequence order and the writer is one ordered worker."""
        lookahead = max(2 * self.args.batch_frames, self.args.prep_workers)
        write_futs = []
        with ThreadPoolExecutor(self.args.prep_workers) as prep, \
                ThreadPoolExecutor(1) as writer:
            seq_iter = iter(self.seqs)
            futq = deque()

            def submit_next():
                frame = next(seq_iter, None)
                if frame is not None:
                    futq.append((frame, prep.submit(self._prepare_frame,
                                                    frame)))

            for _ in range(lookahead):
                submit_next()
            pending_frames, pending_inputs = [], []
            while futq:
                frame, fut = futq.popleft()
                inputs = fut.result()
                submit_next()
                if inputs is None:
                    continue
                pending_frames.append(frame)
                pending_inputs.append(inputs)
                if len(pending_frames) == self.args.batch_frames:
                    results, losses = self.dispatch_fit(pending_frames,
                                                        pending_inputs)
                    # at most two batches in flight: the running one and
                    # one being written
                    while len(write_futs) > 1:
                        write_futs.pop(0).result()
                    write_futs.append(writer.submit(
                        self.write_batch, pending_frames, results, losses))
                    pending_frames, pending_inputs = [], []
            if pending_frames:
                results, losses = self.dispatch_fit(pending_frames,
                                                    pending_inputs)
                write_futs.append(writer.submit(
                    self.write_batch, pending_frames, results, losses))
            for f in write_futs:
                f.result()


def main(argv=None, device=None):
    """Parse ``argv`` and run.  ``device`` (default ``cuda``; raises
    without a card) is a Python-level argument, not a flag: tests pass
    ``device="cpu"``."""
    args = config_parser().parse_args(argv)
    Runner(args, device=device).run()


if __name__ == "__main__":
    main()
