"""Centroid-error evaluation (counterpart of
``mfcnet_tpu/track/errors.py``; reference utils/localization_utils_v2.py).

Operates on a single sample's class probabilities (H, W, C numpy, NHWC) and
ground-truth mask (H, W). Returns per-keypoint pixel errors with NaN padding
and presence flags, matching the reference's conventions:

  * 5-class toolpose: tips decoded via smoothed local maxima (up to 2 per
    side, order-invariant min-assignment), bases via largest contour
    (utils/localization_utils_v2.py:193-288)
  * 3-class tooltip: tips only (:42-100)
  * 10/11-class endovis15: one centroid per joint class (:102-191)

Host code on the OpenCV/scipy decode of ``track/decode.py``, which imports
``cv2`` inside its functions: importing this module needs no OpenCV, a
call does.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mfcnet_tpu_torch.track.decode import (
    calc_centroids,
    create_circular_mask,
    determine_local_maxima_and_estimate_centroids,
)


def _pad2(cx: List, cy: List):
    """NaN-pad/duplicate to exactly 2 entries (reference :230-267)."""
    if len(cx) == 0:
        return [np.nan, np.nan], [np.nan, np.nan]
    if len(cx) == 1:
        return [cx[0], cx[0]], [cy[0], cy[0]]
    return cx[:2], cy[:2]


def _pad1(cx: List, cy: List):
    if len(cx) == 0:
        return [np.nan], [np.nan]
    return cx[:1], cy[:1]


def _tip_centroids(heatmap, blob):
    mask = create_circular_mask(10, 10).astype(np.float64)
    return determine_local_maxima_and_estimate_centroids(heatmap, blob, mask)


def _pair_error(cx, cy, gx, gy):
    """Order-invariant 2-tip mean error (reference :282-287)."""
    e_id = (
        np.sqrt((cx[0] - gx[0]) ** 2 + (cy[0] - gy[0]) ** 2)
        + np.sqrt((cx[1] - gx[1]) ** 2 + (cy[1] - gy[1]) ** 2)
    ) / 2
    e_sw = (
        np.sqrt((cx[0] - gx[1]) ** 2 + (cy[0] - gy[1]) ** 2)
        + np.sqrt((cx[1] - gx[0]) ** 2 + (cy[1] - gy[0]) ** 2)
    ) / 2
    return np.minimum(e_id, e_sw)


def centroid_error_5_classes(probs: np.ndarray, gt: np.ndarray):
    """toolpose task: classes {1: r-base, 2: r-tip, 3: l-base, 4: l-tip}.

    Returns (err_rtip, err_rbase, err_ltip, err_lbase, p_gt, p, c_gt, c_pred).
    """
    pred = probs.argmax(axis=-1)

    def decode(classes, heat_src, is_pred):
        lb_x, lb_y = calc_centroids(255 * (classes == 3).astype(np.uint8))
        rb_x, rb_y = calc_centroids(255 * (classes == 1).astype(np.uint8))
        lt_heat = (
            heat_src[..., 4] if is_pred else (classes == 4).astype(np.float32)
        )
        rt_heat = (
            heat_src[..., 2] if is_pred else (classes == 2).astype(np.float32)
        )
        lt_x, lt_y = _tip_centroids(lt_heat, classes == 4)
        rt_x, rt_y = _tip_centroids(rt_heat, classes == 2)
        lt_x, lt_y = _pad2(lt_x, lt_y)
        rt_x, rt_y = _pad2(rt_x, rt_y)
        lb_x, lb_y = _pad1(lb_x, lb_y)
        rb_x, rb_y = _pad1(rb_x, rb_y)
        return rt_x, rt_y, rb_x, rb_y, lt_x, lt_y, lb_x, lb_y

    p_rt, p_rty, p_rb, p_rby, p_lt, p_lty, p_lb, p_lby = decode(
        pred, probs, True
    )
    g_rt, g_rty, g_rb, g_rby, g_lt, g_lty, g_lb, g_lby = decode(
        gt, None, False
    )

    c_pred = [p_rt, p_rty, p_rb, p_rby, p_lt, p_lty, p_lb, p_lby]
    c_gt = [g_rt, g_rty, g_rb, g_rby, g_lt, g_lty, g_lb, g_lby]
    present_gt = [not np.isnan(g_rt[0]), not np.isnan(g_rb[0]),
                  not np.isnan(g_lt[0]), not np.isnan(g_lb[0])]
    present = [not np.isnan(p_rt[0]), not np.isnan(p_rb[0]),
               not np.isnan(p_lt[0]), not np.isnan(p_lb[0])]

    err_rc = _pair_error(p_rt, p_rty, g_rt, g_rty)
    err_rb = np.sqrt((p_rb[0] - g_rb[0]) ** 2 + (p_rby[0] - g_rby[0]) ** 2)
    err_lc = _pair_error(p_lt, p_lty, g_lt, g_lty)
    err_lb = np.sqrt((p_lb[0] - g_lb[0]) ** 2 + (p_lby[0] - g_lby[0]) ** 2)
    return err_rc, err_rb, err_lc, err_lb, present_gt, present, c_gt, c_pred


def centroid_error_3_classes(probs: np.ndarray, gt: np.ndarray):
    """tooltip task: {1: right tip, 2: left tip}
    (reference :42-100)."""
    pred = probs.argmax(axis=-1)

    def tips(classes, heat, cls):
        cx, cy = _tip_centroids(heat, classes == cls)
        return _pad2(cx, cy)

    p_lt, p_lty = tips(pred, probs[..., 2], 2)
    p_rt, p_rty = tips(pred, probs[..., 1], 1)
    g_lt, g_lty = tips(gt, (gt == 2).astype(np.float32), 2)
    g_rt, g_rty = tips(gt, (gt == 1).astype(np.float32), 1)

    present_gt = [not np.isnan(g_rt[0]), not np.isnan(g_lt[0])]
    present = [not np.isnan(p_rt[0]), not np.isnan(p_lt[0])]
    err_rc = _pair_error(p_rt, p_rty, g_rt, g_rty)
    err_lc = _pair_error(p_lt, p_lty, g_lt, g_lty)
    c_gt = [g_rt, g_rty, g_lt, g_lty]
    c_pred = [p_rt, p_rty, p_lt, p_lty]
    return err_rc, err_lc, present_gt, present, c_gt, c_pred


def centroid_error_10_classes(probs: np.ndarray, gt: np.ndarray):
    """endovis15 task: joint classes 1-5 (right) and 6-10 (left)
    (reference :102-191). Returns (err[10], p_gt[10], p[10], c_gt, c_pred)
    ordered [r1..r5, l1..l5]."""
    pred = probs.argmax(axis=-1)
    order = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]

    def decode(classes):
        cs = []
        for cls in order:
            cx, cy = calc_centroids(255 * (classes == cls).astype(np.uint8))
            cs.append(_pad1(cx, cy))
        return cs

    pc = decode(pred)
    gc = decode(gt)
    errs, present_gt, present = [], [], []
    c_gt, c_pred = [], []
    for (px, py), (gx, gy) in zip(pc, gc):
        errs.append(np.sqrt((px[0] - gx[0]) ** 2 + (py[0] - gy[0]) ** 2))
        present_gt.append(not np.isnan(gx[0]))
        present.append(not np.isnan(px[0]))
        c_pred += [px, py]
        c_gt += [gx, gy]
    return errs, present_gt, present, c_gt, c_pred


def centroid_error(probs: np.ndarray, gt: np.ndarray, num_classes: int):
    """Dispatcher (reference :193-199)."""
    if num_classes == 5:
        return centroid_error_5_classes(probs, gt)
    if num_classes == 3:
        return centroid_error_3_classes(probs, gt)
    if num_classes == 11:
        return centroid_error_10_classes(probs, gt)
    raise ValueError("Centroid error supports 3, 5, or 11 classes")
