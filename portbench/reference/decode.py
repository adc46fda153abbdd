"""Plain reference of the keypoint decode and of the tracker's per-frame
rows, written from their definitions (component areas by Pick's theorem on
the hole-filled components, the largest base component's weighted centroid,
the top-2 tip components over the area threshold, gaussian-smoothed tip
heat, local maxima in a circular 10x10 footprint, the distance gate and the
2-tip assignment of the tracker's CSV).

Components are labelled on the host with ``scipy.ndimage`` (8-connected on
the filled mask, the background 4-connected for the holes) and numbered in
raster order of their first pixel, which is the order of their smallest flat
index; the smoothing and the local maxima run in torch on the device the
heat is on. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

TIE_REL, TIE_ABS = 0.02, 2.0
#: class ids: right base, right tip, left base, left tip
R_BASE, R_TIP, L_BASE, L_TIP = 1, 2, 3, 4


def _fill_holes(m):
    bg_lab, _ = ndimage.label(~m, structure=ndimage.generate_binary_structure(
        2, 1))
    border = np.unique(np.concatenate([bg_lab[0], bg_lab[-1], bg_lab[:, 0],
                                       bg_lab[:, -1]]))
    reach = np.isin(bg_lab, border[border > 0])
    return m | (~m & ~reach)


def component_stats(m):
    """(H, W) bool -> per component, in order of its smallest flat index:
    (areas, weight sums, x sums, y sums) of the hole-filled components, and
    the (H, W) component index map (-1 outside). Area = pixels - boundary/2
    - 1; boundary pixels (a 4-neighbour outside) weigh 0.5, others 1."""
    H, W = m.shape
    filled = _fill_holes(m)
    lab, n = ndimage.label(filled, structure=np.ones((3, 3), bool))
    fp = np.pad(filled, 1)
    interior = (fp[:-2, 1:-1] & fp[2:, 1:-1] & fp[1:-1, :-2] & fp[1:-1, 2:]
                & filled)
    idx = lab.ravel() - 1
    on = idx >= 0
    ii = idx[on]
    w = np.where(interior.ravel()[on], 1.0, 0.5)
    pix = np.nonzero(on)[0]
    counts = np.bincount(ii, minlength=n).astype(np.float64)
    bnd = np.bincount(ii, weights=(~interior.ravel()[on]).astype(np.float64),
                      minlength=n)
    sw = np.bincount(ii, weights=w, minlength=n)
    swx = np.bincount(ii, weights=w * (pix % W), minlength=n)
    swy = np.bincount(ii, weights=w * (pix // W), minlength=n)
    areas = counts - 0.5 * bnd - 1.0
    return (areas.astype(np.float32), sw.astype(np.float32),
            swx.astype(np.float32), swy.astype(np.float32), idx.reshape(H, W))


def _top(areas, k):
    """Indices of the k largest areas, ties to the lower index; areas past
    the components read -1 (an empty bucket)."""
    a = np.full(max(k, len(areas)), -1.0, np.float32)
    a[:len(areas)] = areas
    order = np.argsort(-a, kind="stable")[:k]
    return a[order], order


def base_row(m, thr):
    """(x, y, valid, tie) of the largest component of mask ``m``."""
    areas, sw, swx, swy, _ = component_stats(m)
    (s1, s2), (i1, _) = _top(areas, 2)
    tie = (s2 > 0) and (s1 - s2 <= TIE_ABS + TIE_REL * s1)
    valid = float(s1 >= thr and s1 > 0)
    if i1 < len(areas):
        wsum = max(sw[i1], np.float32(1.0))
        cx, cy = swx[i1] / wsum, swy[i1] / wsum  # float32 quotients
    else:
        cx = cy = 0.0
    return cx, cy, valid, float(tie) * valid


def tip_keep(m, thr):
    """The top-2 components of tip mask ``m`` of area >= thr as a mask, and
    the near-tie flag of that choice."""
    areas, _, _, _, ids = component_stats(m)
    (a1, a2, a3), (i1, i2, _) = _top(areas, 3)
    keep = (((ids == i1) & (a1 >= thr)) | ((ids == i2) & (a2 >= thr)))

    def near(v):
        return v >= 0 and abs(v - thr) <= TIE_ABS

    tie = ((a2 > 0 and a3 >= thr - TIE_ABS
            and a2 - a3 <= TIE_ABS + TIE_REL * max(a2, 0.0))
           or near(a1) or near(a2) or near(a3))
    return keep, tie


def _symmetric_pad(x, r):
    """Pad the last two axes by ``r`` repeating the edge sample (scipy's
    'reflect')."""
    H, W = x.shape[-2:]

    def idx(n):
        i = torch.arange(-r, n + r, device=x.device)
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= n, 2 * n - i - 1, i)

    return x.index_select(-2, idx(H)).index_select(-1, idx(W))


def gaussian_smooth(img, sigma=4.0, truncate=4.0):
    """scipy.ndimage.gaussian_filter of (H, W) float32 with 'reflect'
    borders, as two 1-D convolutions."""
    r = int(truncate * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    k = torch.exp(-0.5 * x * x / sigma ** 2)
    k = (k / k.sum()).float().to(img.device)
    p = _symmetric_pad(img[None, None], r)
    p = F.conv2d(p, k.view(1, 1, 1, -1))
    return F.conv2d(p, k.view(1, 1, -1, 1))[0, 0]


def footprint_offsets(size=10):
    """(dy, dx) of a circular footprint of ``size`` (centre size // 2,
    radius size // 2), as scipy places an even footprint."""
    c = size // 2
    return [(i - c, j - c) for i in range(size) for j in range(size)
            if math.sqrt((i - c) ** 2 + (j - c) ** 2) <= c]


def window_max(sm, size=10, centre=True):
    """scipy.ndimage.maximum_filter(sm, footprint), 'reflect'; without the
    footprint's centre where ``centre`` is False."""
    r = size // 2
    H, W = sm.shape
    p = _symmetric_pad(sm, r)
    mx = None
    for dy, dx in footprint_offsets(size):
        if (dy, dx) == (0, 0) and not centre:
            continue
        win = p[r + dy:r + dy + H, r + dx:r + dx + W]
        mx = win if mx is None else torch.maximum(mx, win)
    return mx


class Tips:
    """One side's tip search: the smoothed heat ``sm`` (zero outside the
    blob), its footprint maximum ``mx`` (``mx_others``: without the
    centre) and the pixels a tip may take
    (``allowed``: the kept components); ``rows`` (2, 3) are the top-2 local
    maxima (sm == mx) over ``allowed``, ties to the lower raster index."""

    def __init__(self, heat, blob, keep):
        H, W = heat.shape
        dev = heat.device
        masked = torch.where(torch.from_numpy(blob).to(dev), heat,
                             torch.zeros_like(heat))
        self.sm = gaussian_smooth(masked)
        self.mx = window_max(self.sm)
        self.mx_others = window_max(self.sm, centre=False)
        self.allowed = torch.from_numpy(blob & keep).to(dev)
        lm = (self.mx == self.sm) & self.allowed
        vals = torch.where(lm, self.sm, torch.full_like(self.sm,
                                                        float("-inf")))
        v, i = torch.sort(vals.ravel(), descending=True, stable=True)
        v, i = v[:2].cpu().numpy(), i[:2].cpu().numpy()
        self.values = v
        self.rows = np.stack([(i % W).astype(np.float32),
                              (i // W).astype(np.float32),
                              np.isfinite(v).astype(np.float32)], axis=-1)

    def tied(self, x, y, tol):
        """Whether (x, y) is a local maximum only within ``tol``: another
        pixel of its footprint lies within ``tol`` of it."""
        x, y = int(x), int(y)
        return float(self.mx_others[y, x]) >= float(self.sm[y, x]) - tol

    def accepts(self, x, y, tol):
        """Whether this search could return a tip at (x, y) with the heat
        moved by up to ``tol``: an allowed pixel within ``tol`` of its
        footprint's maximum."""
        x, y = int(x), int(y)
        return bool(self.allowed[y, x]) and (
            float(self.mx[y, x]) - float(self.sm[y, x]) <= tol)


def decode_frame(mask, heat_l, heat_r, area_threshold=10.0):
    """One frame: (H, W) class ids (numpy) and the left-tip (class 4) and
    right-tip (class 2) heat (torch float32) -> ((2, 3, 3) keypoints
    [left, right][tip1, tip2, base][x, y, valid], each side's
    :class:`Tips`); a base's valid is 2 where a near-tie makes the side
    approximation-sensitive."""
    out = np.zeros((2, 3, 3), np.float32)
    tips = []
    for s, (bcls, tcls, heat) in enumerate(((L_BASE, L_TIP, heat_l),
                                            (R_BASE, R_TIP, heat_r))):
        bx, by, bvalid, btie = base_row(mask == bcls, area_threshold)
        blob = mask == tcls
        keep, ttie = tip_keep(blob, area_threshold)
        t = Tips(heat, blob, keep)
        out[s, :2] = t.rows
        tips.append(t)
        side_tie = min(btie + float(ttie) * bvalid, 1.0)
        out[s, 2] = (bx, by, bvalid + side_tie)
    return out, tips


def tracker_rows(kps_seq, n_rows, dist_threshold=40.0,
                 replicate_left_prev_bug=True):
    """The tracker CSV's rows from per-frame keypoints (None for a frame
    without an output), without the host re-decode: a side's base when
    valid, its tips within ``dist_threshold`` of it, two tips ordered by the
    smaller summed distance to the previous frame's; the left side keeps
    its previous x from the tips' y columns, as the reference does."""
    rows = np.full((max(n_rows, len(kps_seq), 1), 12), np.nan)
    prev = {0: (np.zeros(2), np.zeros(2)), 1: (np.zeros(2), np.zeros(2))}
    for f, kps in enumerate(kps_seq):
        if kps is None:
            continue
        row = rows[f]
        for s, (tcol, bcol) in enumerate(((0, 8), (4, 10))):
            arr = kps[s]
            bx, by, bvalid = arr[2]
            if bvalid <= 0:
                continue
            row[bcol], row[bcol + 1] = bx, by
            # in the keypoints' own float32, as the tracker gates them
            tips = [(x, y) for x, y, v in arr[:2]
                    if v > 0 and np.sqrt((bx - x) ** 2 + (by - y) ** 2)
                    < dist_threshold]
            if not tips:
                pass
            elif len(tips) == 1:
                (x, y), = tips
                row[tcol:tcol + 4] = [x, y, x, y]
            else:
                cxp, cyp = prev[s]
                (x1, y1), (x2, y2) = tips[:2]

                def d(x, y, k):
                    return float(np.sqrt((x - cxp[k]) ** 2 + (y - cyp[k]) ** 2))

                if d(x1, y1, 0) + d(x2, y2, 1) < d(x1, y1, 1) + d(x2, y2, 0):
                    row[tcol:tcol + 4] = [x1, y1, x2, y2]
                else:
                    row[tcol:tcol + 4] = [x2, y2, x1, y1]
            cxp, cyp = prev[s]
            if s == 0 and replicate_left_prev_bug:
                prev[s] = (row[tcol + 1:tcol + 4:2].copy(), cyp)
            else:
                prev[s] = (row[tcol:tcol + 4:2].copy(),
                           row[tcol + 1:tcol + 4:2].copy())
    return rows
