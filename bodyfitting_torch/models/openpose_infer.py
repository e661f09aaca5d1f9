"""OpenPose inference: multiscale maps, peaks, PAF limb assembly, JSONs.

Counterpart of ``bodyfitting_tpu/models/openpose_infer.py`` around
:mod:`bodyfitting_torch.models.openpose`, with the same detector
semantics (the published OpenPose algorithm: multiscale maps averaged at
the input resolution, smoothed-heatmap peaks, PAF line-integral limb
scores, greedy matching and person grouping, hand and face boxes from
the body keypoints) and the same JSON files.

Where the work runs:

* on the device: the nets, batched over a frame's views at each scale
  (all views share one shape and every convolution is per-sample, so the
  values are those of one-image calls) and chunked to bound memory; the
  uint8 input resize and the map resizes (``io/images.py``); the
  scipy-exact Gaussian smoothing and the 4-neighbour peak test; the PAF
  samples of every candidate limb, gathered at once;
* on the host, in numpy, as the JAX package has them: the greedy limb
  matching and person grouping (data-dependent), ``scipy.ndimage.label``
  of the hand and face blobs, the boxes and the JSON.  Only the peaks,
  the PAF samples and the hand and face maps are copied to the host.

``find_peaks``, ``assemble_people`` and ``_crop_peaks_with_scores`` keep
the JAX functions' numpy signatures (the tests hold the two packages to
each other with them); the ``*_batch`` / ``*_device`` functions are the
card's path, equal to them on the same maps.  The numpy functions are
that path's host reference: ``chip_smoke.py`` holds the card's peaks,
people and crop peaks to them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from bodyfitting_torch.device import default_device
from bodyfitting_torch.io.images import (
    imread_checked,
    resize_maps_cubic,
    resize_u8_cubic_fx,
)

# BODY_25-style limb/PAF tables for the 18-part COCO model (published
# OpenPose constants).
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
MAP_IDX = [
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
    [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
    [53, 54], [51, 52], [55, 56], [37, 38], [45, 46],
]

# COCO-18 -> OpenPose BODY_25 slot mapping (BODY_25 adds MidHip(8) and
# foot keypoints 19-24, which the COCO model does not produce).
COCO18_TO_BODY25 = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16,
                    17, 18]

# Bytes of the largest activation of one chunk of a net's batch (its
# first convolution's 64-channel output); a frame's views run in chunks
# of at most this size at each scale.
ACTIVATION_BUDGET_BYTES = 2 << 30


class Stats:
    """Optional per-part timing of a detector (``detector.stats``): each
    part's seconds (the device drained at both ends), calls and bytes
    copied to the host.  Off (``None``) in normal runs."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}
        self.items: dict = {}
        self.inputs: dict = {}      # name -> [(batch, padded H, padded W)]
        self.bytes_to_host = 0

    @contextlib.contextmanager
    def part(self, name, device, items=0):
        _sync(device)
        t = time.perf_counter()
        yield
        _sync(device)
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t)
        self.calls[name] = self.calls.get(name, 0) + 1
        self.items[name] = self.items.get(name, 0) + items


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _part(stats, name, device, items=0):
    return (stats.part(name, device, items) if stats is not None
            else contextlib.nullcontext())


def _to_host(t: torch.Tensor, stats=None) -> np.ndarray:
    if stats is not None and t.device.type != "cpu":
        stats.bytes_to_host += t.numel() * t.element_size()
    return t.cpu().numpy()


def pad_right_down(imgs: torch.Tensor, stride: int, pad_value: int):
    """Pad the H and W of images ``[N, H, W, C]`` down and right up to
    multiples of ``stride`` with ``pad_value``: ``(padded, (0, 0, pad_d,
    pad_r))``."""
    h, w = imgs.shape[1:3]
    pad_d = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    out = torch.nn.functional.pad(imgs, (0, 0, 0, pad_r, 0, pad_d),
                                  value=pad_value)
    return out, (0, 0, pad_d, pad_r)


def multiscale_maps_batch(apply_fn, imgs: torch.Tensor, n_out_list,
                          boxsize=368, stride=8, pad_value=128,
                          scales=(0.5, 1.0, 1.5, 2.0), stats=None,
                          name="net"):
    """Average per-scale network outputs, resized to the input resolution,
    for a batch of uint8 images ``[N, H, W, 3]`` of one shape: a list of
    float32 ``[N, n, H, W]`` maps on the images' device.

    ``apply_fn`` takes NCHW ``x / 256 - 0.5`` images and returns one map
    tensor or a tuple of them at stride 8.  The batch runs in chunks that
    keep a 64-channel activation under :data:`ACTIVATION_BUDGET_BYTES`."""
    N, H, W = imgs.shape[:3]
    dev = imgs.device
    avgs = [torch.zeros((N, n, H, W), dtype=torch.float32, device=dev)
            for n in n_out_list]
    for s in scales:
        scale = s * boxsize / H
        oh, ow = int(round(H * scale)), int(round(W * scale))   # OpenCV's
        ph, pw = -(-oh // stride) * stride, -(-ow // stride) * stride
        chunk = max(1, ACTIVATION_BUDGET_BYTES // (64 * ph * pw * 4))
        for c0 in range(0, N, chunk):
            part = imgs[c0:c0 + chunk]
            if stats is not None:
                stats.inputs.setdefault(name, []).append((len(part), ph, pw))
            with _part(stats, f"{name}/scale{s:g}", dev, len(part)):
                padded, _ = pad_right_down(resize_u8_cubic_fx(part, scale),
                                           stride, pad_value)
                inp = (padded.to(torch.float32) / 256.0 - 0.5).permute(
                    0, 3, 1, 2)
                with torch.inference_mode():
                    outs = apply_fn(inp)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for oi, out in enumerate(outs):
                    m = resize_maps_cubic(out.to(torch.float32).contiguous(),
                                          factor=stride)
                    m = resize_maps_cubic(m[:, :, :oh, :ow].contiguous(),
                                          size=(H, W))
                    avgs[oi][c0:c0 + chunk] += m / len(scales)
    return avgs


def _multiscale_maps(apply_fn, ori_img, n_out_list, boxsize=368, stride=8,
                     pad_value=128, scales=(0.5, 1.0, 1.5, 2.0), device=None):
    """The JAX function's contract on one uint8 image ``[H, W, 3]``: a list
    of float32 ``[H, W, n]`` numpy maps, computed on ``device`` (default
    ``cuda``; raises without a card)."""
    imgs = torch.as_tensor(np.ascontiguousarray(ori_img))[None].to(
        default_device(device))
    avgs = multiscale_maps_batch(apply_fn, imgs, n_out_list, boxsize,
                                 stride, pad_value, scales)
    return [a[0].permute(1, 2, 0).cpu().numpy() for a in avgs]


# ---------------------------------------------------------------------------
# Smoothing and peaks
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage's float64 Gaussian weights."""
    p = np.polynomial.Polynomial([0, 0, -0.5 / (sigma * sigma)])
    x = np.arange(-radius, radius + 1)
    phi = np.exp(p(x), dtype=np.double)
    phi /= phi.sum()
    return phi


def _reflect_index(n: int, radius: int) -> np.ndarray:
    """Source rows of a line extended by ``radius`` on each side in
    scipy's ``reflect`` mode (d c b a | a b c d), periodic for short
    lines."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def gaussian_smooth(maps: torch.Tensor, sigma: float = 3.0,
                    truncate: float = 4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(m, sigma)`` of each 2D map of
    ``maps [..., H, W]`` (float32), bit for bit: the filter runs along H,
    stores float32, then along W, each pass in float64 summing the centre
    tap and then the mirrored pairs from the outermost in, as scipy's
    symmetric correlation does, with ``reflect`` borders."""
    radius = int(truncate * float(sigma) + 0.5)
    w = _gaussian_kernel1d(float(sigma), radius)
    out = maps
    for dim in (-2, -1):
        n = out.shape[dim]
        idx = torch.as_tensor(_reflect_index(n, radius), device=out.device)
        xp = out.to(torch.float64).index_select(dim, idx)

        def tap(off):
            return xp.narrow(dim, radius + off, n)

        acc = tap(0) * float(w[radius])
        for j in range(radius, 0, -1):
            acc = acc + (tap(-j) + tap(j)) * float(w[radius - j])
        out = acc.to(torch.float32)
    return out


def _peak_mask(sm: torch.Tensor, thre: float) -> torch.Tensor:
    """The 4-neighbour ``>=`` local maxima above ``thre`` of smoothed maps
    ``[..., H, W]`` (neighbours outside the map read 0)."""
    z = torch.zeros_like(sm)
    up = torch.cat([z[..., :1, :], sm[..., :-1, :]], -2)
    down = torch.cat([sm[..., 1:, :], z[..., :1, :]], -2)
    left = torch.cat([z[..., :1], sm[..., :-1]], -1)
    right = torch.cat([sm[..., 1:], z[..., :1]], -1)
    return ((sm >= up) & (sm >= down) & (sm >= left) & (sm >= right)
            & (sm > thre))


def find_peaks(heatmap_avg: np.ndarray, thre1: float = 0.1):
    """Per-part peak lists ``[(x, y, score, id), ...]`` of a ``[H, W, 19]``
    numpy heatmap on the host, as the JAX function computes them (scipy's
    ``gaussian_filter``)."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    counter = 0
    for part in range(heatmap_avg.shape[2] - 1):      # last ch = background
        m = heatmap_avg[:, :, part]
        sm = gaussian_filter(m, sigma=3)
        left = np.zeros_like(sm); left[1:, :] = sm[:-1, :]        # noqa: E702
        right = np.zeros_like(sm); right[:-1, :] = sm[1:, :]      # noqa: E702
        up = np.zeros_like(sm); up[:, 1:] = sm[:, :-1]            # noqa: E702
        down = np.zeros_like(sm); down[:, :-1] = sm[:, 1:]        # noqa: E702
        binary = ((sm >= left) & (sm >= right) & (sm >= up) & (sm >= down)
                  & (sm > thre1))
        ys, xs = np.nonzero(binary)
        peaks = [(int(x), int(y), float(m[y, x]), counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def find_peaks_batch(heat: torch.Tensor, thre1: float = 0.1, stats=None,
                     view_chunk: int = 8):
    """:func:`find_peaks` of each view of ``heat [N, 19, H, W]`` where the
    tensor lies: one list of per-part peak lists a view.  Smoothing and
    the peak test run on the device, ``view_chunk`` views at a time; only
    the peaks' positions and scores are copied to the host."""
    N, C = heat.shape[:2]
    rows, vals = [], []
    for c0 in range(0, N, view_chunk):
        m = heat[c0:c0 + view_chunk, :C - 1]
        nz = _peak_mask(gaussian_smooth(m), thre1).nonzero()
        vals.append(m[nz[:, 0], nz[:, 1], nz[:, 2], nz[:, 3]])
        nz[:, 0] += c0
        rows.append(nz)
    rows = _to_host(torch.cat(rows), stats)
    vals = _to_host(torch.cat(vals), stats)
    out = [[[] for _ in range(C - 1)] for _ in range(N)]
    counters = [0] * N
    for (n, part, y, x), v in zip(rows.tolist(), vals.tolist()):
        out[n][part].append((x, y, v, counters[n]))
        counters[n] += 1
    return out


# ---------------------------------------------------------------------------
# Limb assembly
# ---------------------------------------------------------------------------


def _sample_positions(peaks_a, peaks_b, mid_num):
    """``(xs, ys)`` ``[|A| |B|, mid_num]`` integer sample positions of every
    (a, b) pair in row-major pair order: ``np.round(np.linspace(a, b,
    mid_num))``, computed for all pairs at once with linspace's own
    float64 steps (``start + arange * (stop - start) / (num - 1)``, the
    last sample set to ``stop``)."""
    a = np.asarray([p[:2] for p in peaks_a], np.float64).reshape(-1, 2)
    b = np.asarray([p[:2] for p in peaks_b], np.float64).reshape(-1, 2)
    start = np.repeat(a, len(b), axis=0)                 # [P, 2]
    stop = np.tile(b, (len(a), 1))
    t = np.arange(mid_num, dtype=np.float64)[None, :, None]
    y = t * ((stop - start) / (mid_num - 1))[:, None, :] + start[:, None, :]
    y[:, -1] = stop
    pos = np.round(y).astype(int)
    return pos[..., 0], pos[..., 1]


def _links_from_samples(peaks_a, peaks_b, vals, img_h, thre2, mid_num):
    """The JAX ``_limb_links`` on PAF samples ``vals [|A| |B|, mid_num, 2]``
    (float32, row-major pair order): score every pair by its mean
    alignment plus a length penalty, keep those with >80 % of the samples
    above ``thre2`` and a positive score, accept best-first while neither
    endpoint is taken, up to ``min(|A|, |B|)`` links.  Returns
    ``[(global_peak_id_a, global_peak_id_b, score)]``."""
    scored = []
    nb = len(peaks_b)
    for i, a in enumerate(peaks_a):
        for j, b in enumerate(peaks_b):
            dx, dy = b[0] - a[0], b[1] - a[1]
            length = max(math.hypot(dx, dy), 0.1)
            along = vals[i * nb + j] @ (
                np.array([dx, dy], np.float64) / length)
            score = along.mean() + min(0.5 * img_h / length - 1, 0)
            if np.count_nonzero(along > thre2) > 0.8 * mid_num and score > 0:
                scored.append((i, j, score))
    scored.sort(key=lambda t: t[2], reverse=True)
    links, taken_a, taken_b = [], set(), set()
    for i, j, score in scored:
        if i in taken_a or j in taken_b:
            continue
        links.append((int(peaks_a[i][3]), int(peaks_b[j][3]), score))
        taken_a.add(i)
        taken_b.add(j)
        if len(links) >= min(len(peaks_a), len(peaks_b)):
            break
    return links


def _limb_links(peaks_a, peaks_b, paf_xy, img_h, thre2, mid_num):
    """The JAX function on a numpy ``paf_xy [H, W, 2]``."""
    xs, ys = _sample_positions(peaks_a, peaks_b, mid_num)
    return _links_from_samples(peaks_a, peaks_b, paf_xy[ys, xs], img_h,
                               thre2, mid_num)


class _PersonDraft:
    """A person being assembled: one global peak id per COCO-18 part slot
    (-1 = unfilled), the running score (member peak scores + limb scores)
    and the filled-part count."""

    __slots__ = ("part_peak", "score", "n_parts")

    def __init__(self):
        self.part_peak = np.full(18, -1, np.int64)
        self.score = 0.0
        self.n_parts = 0


def _assemble(all_peaks, limb_links):
    """Group the accepted links of each limb type (``limb_links[k]``) into
    people: ``(candidate [N, 4], subset [P, 20])``.  The JAX
    ``assemble_people``'s grouping, its quirks included (a draft matched
    only through its B-endpoint never gains the link's A-endpoint;
    overlapping drafts absorb the B-endpoint into the first; a link
    matching >= 3 drafts handles the first two)."""
    candidate = np.array([p for peaks in all_peaks for p in peaks],
                         np.float64).reshape(-1, 4)
    peak_score = candidate[:, 2] if len(candidate) else np.zeros(0)

    people = []
    for k, (pa, pb) in enumerate(LIMB_SEQ):
        slot_a, slot_b = pa - 1, pb - 1
        for id_a, id_b, limb_score in limb_links[k]:
            owners = [p for p in people
                      if p.part_peak[slot_a] == id_a
                      or p.part_peak[slot_b] == id_b]
            if len(owners) == 1:
                p = owners[0]
                if p.part_peak[slot_b] != id_b:
                    p.part_peak[slot_b] = id_b
                    p.n_parts += 1
                    p.score += peak_score[id_b] + limb_score
            elif len(owners) >= 2:
                first, second = owners[0], owners[1]
                overlap = ((first.part_peak >= 0)
                           & (second.part_peak >= 0)).any()
                if not overlap:
                    take = first.part_peak < 0
                    first.part_peak[take] = second.part_peak[take]
                    first.n_parts += second.n_parts
                    first.score += second.score + limb_score
                    people.remove(second)
                else:
                    first.part_peak[slot_b] = id_b
                    first.n_parts += 1
                    first.score += peak_score[id_b] + limb_score
            elif k < 17:
                p = _PersonDraft()
                p.part_peak[slot_a] = id_a
                p.part_peak[slot_b] = id_b
                p.n_parts = 2
                p.score = peak_score[id_a] + peak_score[id_b] + limb_score
                people.append(p)

    kept = [p for p in people
            if p.n_parts >= 4 and p.score / p.n_parts >= 0.4]
    subset = np.full((len(kept), 20), -1.0)
    for r, p in enumerate(kept):
        subset[r, :18] = p.part_peak
        subset[r, 18] = p.score
        subset[r, 19] = p.n_parts
    return candidate, subset


def assemble_people(all_peaks, paf_avg, img_h, thre2: float = 0.05,
                    mid_num: int = 100):
    """Greedy PAF limb assembly on a numpy ``paf_avg [H, W, 38]`` ->
    ``(candidate [N, 4], subset [P, 20])`` (the JAX function)."""
    links = []
    for (pa, pb), (mx, my) in zip(LIMB_SEQ, MAP_IDX):
        paf_xy = paf_avg[:, :, [mx - 19, my - 19]]
        links.append(_limb_links(all_peaks[pa - 1], all_peaks[pb - 1],
                                 paf_xy, img_h, thre2, mid_num))
    return _assemble(all_peaks, links)


def assemble_people_batch(peaks_per_view, paf: torch.Tensor, img_h,
                          thre2: float = 0.05, mid_num: int = 100,
                          stats=None):
    """:func:`assemble_people` of each view of ``paf [N, 38, H, W]`` where
    the tensor lies: the sample positions of every candidate limb of
    every view are built on the host, the PAF is sampled there with one
    gather, and only the samples are copied back; scoring, matching and
    grouping run on the host as in :func:`assemble_people`."""
    N, C, H, W = paf.shape
    jobs, flat = [], []
    for n, all_peaks in enumerate(peaks_per_view):
        for k, ((pa, pb), (mx, my)) in enumerate(zip(LIMB_SEQ, MAP_IDX)):
            A, B = all_peaks[pa - 1], all_peaks[pb - 1]
            if not A or not B:
                continue
            xs, ys = _sample_positions(A, B, mid_num)
            base = (n * C + np.array([mx - 19, my - 19])) * H
            flat.append((base[None, None, :] + ys[..., None]) * W
                        + xs[..., None])
            jobs.append((n, k, len(A) * len(B)))
    vals = np.zeros((0, mid_num, 2), np.float32)
    if flat:
        with _part(stats, "body/paf_gather", paf.device):
            idx = torch.as_tensor(np.concatenate(flat), device=paf.device)
            vals = _to_host(paf.contiguous().reshape(-1)[idx], stats)
    with _part(stats, "body/assembly", "cpu"):
        links = [[[] for _ in LIMB_SEQ] for _ in range(N)]
        off = 0
        for n, k, npairs in jobs:
            pa, pb = LIMB_SEQ[k]
            links[n][k] = _links_from_samples(
                peaks_per_view[n][pa - 1], peaks_per_view[n][pb - 1],
                vals[off:off + npairs], img_h, thre2, mid_num)
            off += npairs
        return [_assemble(peaks_per_view[n], links[n]) for n in range(N)]


# ---------------------------------------------------------------------------
# Boxes and keypoints (host)
# ---------------------------------------------------------------------------


def hand_boxes(candidate, subset, img_shape, ratio_wrist_elbow=0.33):
    """Square hand crops from body keypoints: ``[(x, y, w, is_left)]``."""
    H, W = img_shape[:2]
    out = []
    for person in subset.astype(int):
        for (s_i, e_i, w_i, is_left) in ((5, 6, 7, True), (2, 3, 4, False)):
            if (person[[s_i, e_i, w_i]] == -1).any():
                continue
            x1, y1 = candidate[person[s_i]][:2]
            x2, y2 = candidate[person[e_i]][:2]
            x3, y3 = candidate[person[w_i]][:2]
            x = x3 + ratio_wrist_elbow * (x3 - x2)
            y = y3 + ratio_wrist_elbow * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x -= width / 2
            y -= width / 2
            x, y = max(x, 0), max(y, 0)
            width = min(width, W - x, H - y)
            if width >= 20:
                out.append((int(x), int(y), int(width), is_left))
    return out


def face_box(candidate, person_row, img_shape):
    """Square face crop from body keypoints, ``(x, y, w)`` or ``None``:
    centred on the nose (else the eye/ear mean), sized from the neck-nose
    distance (else the inter-ear or inter-eye span)."""
    H, W = img_shape[:2]
    person = person_row.astype(int)

    def pt(part):                       # COCO-18, 0-based
        idx = person[part]
        return candidate[idx][:2] if idx >= 0 else None

    nose, neck = pt(0), pt(1)
    eyes = [p for p in (pt(14), pt(15)) if p is not None]
    ears = [p for p in (pt(16), pt(17)) if p is not None]
    head_pts = [p for p in [nose] + eyes + ears if p is not None]
    if not head_pts:
        return None
    center = np.mean(head_pts, axis=0)
    if nose is not None and neck is not None:
        size = 1.5 * math.hypot(*(np.asarray(nose) - neck))
    elif len(ears) == 2:
        size = 3.0 * math.hypot(*(np.asarray(ears[0]) - ears[1]))
    elif len(eyes) == 2:
        size = 4.0 * math.hypot(*(np.asarray(eyes[0]) - eyes[1]))
    else:
        size = 0.25 * H
    x = max(center[0] - size / 2, 0)
    y = max(center[1] - size / 2, 0)
    size = min(size, W - x, H - y)
    if size < 20:
        return None
    return int(x), int(y), int(size)


def person_to_body25(candidate, person_row):
    """One subset row -> BODY_25 ``(u, v, conf)`` keypoints ``[25, 3]``."""
    out = np.zeros((25, 3), np.float32)
    for coco_i, b25_i in enumerate(COCO18_TO_BODY25):
        idx = int(person_row[coco_i])
        if idx >= 0:
            out[b25_i] = candidate[idx][:3]
    # MidHip (8) from the two hips when both exist
    if out[9, 2] > 0 and out[12, 2] > 0:
        out[8, :2] = (out[9, :2] + out[12, :2]) / 2
        out[8, 2] = min(out[9, 2], out[12, 2])
    return out


def _blob_peaks(sm_binary, heat):
    """Per part the strongest 8-connected blob's peak ``[x, y, score]``
    (score 0: a miss) from the thresholded smoothed maps ``[n, H, W]``
    (bool) and the raw maps ``[n, H, W]`` (float32), on the host."""
    from scipy.ndimage import label

    peaks = []
    for binary, m in zip(sm_binary, heat):
        if binary.sum() == 0:
            peaks.append([0.0, 0.0, 0.0])
            continue
        # 8-connectivity: scipy's default 4-connectivity splits blobs
        # that touch diagonally
        labels, n = label(binary.astype(np.uint8),
                          structure=np.ones((3, 3), np.uint8))
        sums = [m[labels == i].sum() for i in range(1, n + 1)]
        best = int(np.argmax(sums)) + 1
        masked = np.where(labels == best, m, 0)
        y, x = np.unravel_index(np.argmax(masked), masked.shape)
        peaks.append([float(x), float(y), float(m[y, x])])
    return np.array(peaks, np.float32)


def _crop_peaks_with_scores(heatmap_avg, n_parts: int, thre: float):
    """Per-part strongest-blob peak with its real heatmap score, ``[n_parts,
    3]`` (x, y, score; score 0 marks a miss), from a numpy ``[H, W, C]``
    map on the host with scipy's ``gaussian_filter`` (the JAX function,
    and the host reference of :func:`_crop_peaks_device`)."""
    from scipy.ndimage import gaussian_filter

    heat = [heatmap_avg[:, :, p] for p in range(n_parts)]
    return _blob_peaks([gaussian_filter(m, sigma=3) > thre for m in heat],
                       heat)


def _crop_peaks_device(heat: torch.Tensor, n_parts: int, thre: float,
                       stats=None):
    """:func:`_crop_peaks_with_scores` of a ``[C, H, W]`` map where it
    lies: the smoothing and threshold there, the labelling on the host."""
    m = heat[:n_parts]
    binary = _to_host(gaussian_smooth(m) > thre, stats)
    return _blob_peaks(binary, _to_host(m, stats))


# ---------------------------------------------------------------------------
# Detectors
# ---------------------------------------------------------------------------


def _upload(images, device) -> torch.Tensor:
    """A list of same-shape uint8 ``[H, W, 3]`` images as one ``[N, H, W,
    3]`` tensor on ``device`` (pinned and copied asynchronously on a
    CUDA device's current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(np.stack(images)))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class BodyDetector:
    """End-to-end body keypoint detector.  ``net`` (the loaded
    :class:`~bodyfitting_torch.models.openpose.BodyPoseNet`, or any
    callable with its contract) is a field the tests replace."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 scales=(0.5, 1.0, 1.5, 2.0), device=None):
        from bodyfitting_torch.models.openpose import load_body_net

        self.device = default_device(device)
        self.net = load_body_net(checkpoint_path, self.device)
        self.scales = scales
        self.boxsize = 368
        self.stats: Optional[Stats] = None

    def maps(self, imgs: torch.Tensor):
        """``(paf [N, 38, H, W], heatmap [N, 19, H, W])`` of uint8 images
        ``[N, H, W, 3]`` on the detector's device."""
        return multiscale_maps_batch(self.net, imgs, [38, 19],
                                     boxsize=self.boxsize,
                                     scales=self.scales, stats=self.stats,
                                     name="body")

    def detect(self, images):
        """``[(candidate, subset)]`` of a list of uint8 ``[H, W, 3]`` images,
        each shape's images in one batch."""
        out = [None] * len(images)
        groups: dict = {}
        for i, img in enumerate(images):
            groups.setdefault(img.shape, []).append(i)
        for shape, ids in groups.items():
            imgs = _upload([images[i] for i in ids], self.device)
            paf, heat = self.maps(imgs)
            with _part(self.stats, "body/peaks", self.device):
                peaks = find_peaks_batch(heat, stats=self.stats)
            res = assemble_people_batch(peaks, paf, shape[0],
                                        stats=self.stats)
            for i, r in zip(ids, res):
                out[i] = r
        return out

    def __call__(self, ori_img: np.ndarray):
        return self.detect([ori_img])[0]


class _CropDetector:
    n_parts = 0
    n_out = 0
    kind = ""

    def __init__(self, checkpoint_path, scales, boxsize, device):
        from bodyfitting_torch.models import openpose as op

        self.device = default_device(device)
        self.net = getattr(op, f"load_{self.kind}_net")(checkpoint_path,
                                                        self.device)
        self.scales = scales
        self.boxsize = boxsize
        self.stats: Optional[Stats] = None

    def __call__(self, crop_img: np.ndarray, thre: float = 0.05):
        imgs = _upload([crop_img], self.device)
        (heat,) = multiscale_maps_batch(
            self.net, imgs, [self.n_out], boxsize=self.boxsize,
            scales=self.scales, stats=self.stats, name=self.kind)
        with _part(self.stats, f"{self.kind}/peaks", self.device):
            return _crop_peaks_device(heat[0], self.n_parts, thre,
                                      self.stats)


class HandDetector(_CropDetector):
    """21-keypoint hand detector on a square crop (four scales)."""

    n_parts, n_out, kind = 21, 22, "hand"

    def __init__(self, checkpoint_path: Optional[str] = None,
                 scales=(0.5, 1.0, 1.5, 2.0), device=None):
        super().__init__(checkpoint_path, scales, 368, device)


class FaceDetector(_CropDetector):
    """70-keypoint face detector on a square crop (one scale, box 368):
    the counterpart of the OpenPose binary's ``--face`` stage."""

    n_parts, n_out, kind = 70, 71, "face"

    def __init__(self, checkpoint_path: Optional[str] = None,
                 scales=(1.0,), boxsize: int = 368, device=None):
        super().__init__(checkpoint_path, scales, boxsize, device)


def detect_to_json(image_dir: str, write_dir: str, body, hand=None,
                   hand_face: bool = False, face=None):
    """Detect over a directory and write OpenPose-format JSONs: per image
    ``<stem>_keypoints.json`` with ``people[*].pose_keypoints_2d`` (75
    floats) and, with ``hand_face``, the hand (63 floats each) and face
    (210 floats) blocks; confidences are the heatmap peak scores.

    The body runs on all images at once when ``body`` has a ``detect``
    method (one batch per image shape), else image by image; hands and
    faces crop by crop.  The JSONs are written after the detectors'
    device work has finished."""
    os.makedirs(write_dir, exist_ok=True)
    names = [n for n in sorted(os.listdir(image_dir))
             if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    images = [imread_checked(os.path.join(image_dir, n)) for n in names]
    detect = getattr(body, "detect", None)
    found = (detect(images) if detect is not None
             else [body(img) for img in images])
    docs = []
    for img, (candidate, subset) in zip(images, found):
        people = []
        for row in subset:
            b25 = person_to_body25(candidate, row)
            person = {"pose_keypoints_2d": [float(v) for v in b25.reshape(-1)]}
            if hand_face and hand is not None:
                lh = np.zeros((21, 3), np.float32)
                rh = np.zeros((21, 3), np.float32)
                for (x, y, w, is_left) in hand_boxes(candidate, row[None],
                                                     img.shape):
                    crop = img[y:y + w, x:x + w]
                    if is_left:
                        crop = np.ascontiguousarray(crop[:, ::-1])
                    block = hand(crop).astype(np.float32)    # [21, 3]
                    if is_left:
                        block[:, 0] = w - 1 - block[:, 0]
                    block[:, :2] += np.array([x, y], np.float32)
                    block[:, :2] *= (block[:, 2:] > 0)       # zero misses
                    if is_left:
                        lh = block
                    else:
                        rh = block
                person["hand_left_keypoints_2d"] = [float(v) for v in
                                                    lh.reshape(-1)]
                person["hand_right_keypoints_2d"] = [float(v) for v in
                                                     rh.reshape(-1)]
            if hand_face and face is not None:
                fkp = np.zeros((70, 3), np.float32)
                box = face_box(candidate, row, img.shape)
                if box is not None:
                    x, y, w = box
                    block = face(img[y:y + w, x:x + w]).astype(np.float32)
                    block[:, :2] += np.array([x, y], np.float32)
                    block[:, :2] *= (block[:, 2:] > 0)
                    fkp = block
                person["face_keypoints_2d"] = [float(v) for v in
                                               fkp.reshape(-1)]
            people.append(person)
        docs.append({"version": 1.3, "people": people})
    for det in (body, hand, face):
        dev = getattr(det, "device", None)
        if dev is not None:
            _sync(dev)
    for name, doc in zip(names, docs):
        stem = os.path.splitext(name)[0]
        with open(os.path.join(write_dir, f"{stem}_keypoints.json"), "w") as f:
            json.dump(doc, f)
