"""Legacy (v1) keypoint decoding -- heatmap-weighted ROI centroids
(counterpart of ``mfcnet_tpu/track/errors_v1.py``; reference
utils/localization_utils.py, used by some infer paths before the v2
local-maxima decode replaced it). ``cv2`` is imported inside the
functions.
"""

from __future__ import annotations

import numpy as np

from mfcnet_tpu_torch.track.errors import _pad1, _pad2, _pair_error


def calc_weighted_centroids(output: np.ndarray, mask: np.ndarray):
    """Heatmap-weighted centroid per top-2 contour ROI, weights < 0.2
    zeroed (reference: utils/localization_utils.py:4-28)."""
    import cv2

    r, c = output.shape
    c_grid, r_grid = np.meshgrid(
        np.linspace(0, c, c + 1), np.linspace(0, r, r + 1),
        sparse=False, indexing="xy",
    )
    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    cnts = sorted(contours, key=cv2.contourArea, reverse=True)[:2]
    cx, cy = [], []
    for cnt in cnts:
        if cv2.contourArea(cnt) < 10:
            continue
        x, y, w, h = cv2.boundingRect(cnt)
        wts = output[y : y + h, x : x + w].copy()
        wts[wts < 0.2] = 0
        if np.sum(wts) == 0:
            continue  # reference drops into pdb here; we skip the contour
        gx = c_grid[y : y + h, x : x + w]
        gy = r_grid[y : y + h, x : x + w]
        cx.append(int(np.sum(wts * gx) / np.sum(wts)))
        cy.append(int(np.sum(wts * gy) / np.sum(wts)))
    return cx, cy


def calc_base_centroid_v1(mask: np.ndarray):
    """Largest-contour centroid, fixed area threshold 10
    (reference: utils/localization_utils.py:30-44)."""
    import cv2

    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    cnts = sorted(contours, key=cv2.contourArea, reverse=True)[:1]
    cx, cy = [], []
    for cnt in cnts:
        if cv2.contourArea(cnt) < 10:
            continue
        m = cv2.moments(cnt)
        if m["m00"] == 0:
            continue
        cx.append(int(m["m10"] / m["m00"]))
        cy.append(int(m["m01"] / m["m00"]))
    return cx, cy


def centroid_error_v1(probs: np.ndarray, gt: np.ndarray):
    """5-class centroid error with weighted-centroid tips
    (reference: utils/localization_utils.py:46-121). probs: (H, W, C)."""
    pred = probs.argmax(axis=-1)

    def decode_pred(tip_cls, base_cls):
        tip_mask = 255 * (pred == tip_cls).astype(np.uint8)
        base_mask = 255 * (pred == base_cls).astype(np.uint8)
        heat = probs[..., tip_cls].copy()
        heat[tip_mask == 0] = 0
        tx, ty = calc_weighted_centroids(heat, tip_mask)
        bx, by = calc_base_centroid_v1(base_mask)
        return _pad2(tx, ty), _pad1(bx, by)

    def decode_gt(tip_cls, base_cls):
        tip_mask = 255 * (gt == tip_cls).astype(np.uint8)
        base_mask = 255 * (gt == base_cls).astype(np.uint8)
        heat = (gt == tip_cls).astype(np.float32)
        tx, ty = calc_weighted_centroids(heat, tip_mask)
        bx, by = calc_base_centroid_v1(base_mask)
        return _pad2(tx, ty), _pad1(bx, by)

    (p_lt, p_lty), (p_lb, p_lby) = decode_pred(4, 3)
    (p_rt, p_rty), (p_rb, p_rby) = decode_pred(2, 1)
    (g_lt, g_lty), (g_lb, g_lby) = decode_gt(4, 3)
    (g_rt, g_rty), (g_rb, g_rby) = decode_gt(2, 1)

    err_rc = _pair_error(p_rt, p_rty, g_rt, g_rty)
    err_rb = np.sqrt((p_rb[0] - g_rb[0]) ** 2 + (p_rby[0] - g_rby[0]) ** 2)
    err_lc = _pair_error(p_lt, p_lty, g_lt, g_lty)
    err_lb = np.sqrt((p_lb[0] - g_lb[0]) ** 2 + (p_lby[0] - g_lby[0]) ** 2)
    present_gt = [not np.isnan(g_rt[0]), not np.isnan(g_rb[0]),
                  not np.isnan(g_lt[0]), not np.isnan(g_lb[0])]
    present = [not np.isnan(p_rt[0]), not np.isnan(p_rb[0]),
               not np.isnan(p_lt[0]), not np.isnan(p_lb[0])]
    return err_rc, err_rb, err_lc, err_lb, present_gt, present
