"""Overlay rendering and flow coloring (counterpart of
``mfcnet_tpu/utils/vis.py``; reference utils/vis_utils.py). ``cv2`` is
imported inside the functions that need it; the flow coloring is numpy
only."""

from __future__ import annotations

import numpy as np


def draw_plus(image, center, color=(0, 255, 0), size=5, thickness=1):
    """NaN-safe keypoint cross (utils/vis_utils.py:22-42)."""
    if np.isnan(center).any():
        return image
    import cv2

    cx, cy = int(center[0]), int(center[1])
    cv2.line(image, (cx, cy - size), (cx, cy + size), color, thickness)
    cv2.line(image, (cx - size, cy), (cx + size, cy), color, thickness)
    return image


def mask_overlay(image, mask, color=(0, 255, 0), wt=0.5):
    """Weighted color overlay where mask>0 (utils/vis_utils.py:44-55)."""
    import cv2

    colored = (np.dstack([mask] * 3) * np.asarray(color)).astype(np.uint8)
    blended = cv2.addWeighted(colored, wt, image, 1 - wt, 0.0)
    out = image.copy()
    sel = colored[:, :, 1] > 0
    out[sel] = blended[sel]
    return out


def make_colorwheel() -> np.ndarray:
    """Standard Middlebury flow colorwheel (55 colors, RY/YG/GC/CB/BM/MR)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_color(flow_uv: np.ndarray, clip_flow=None) -> np.ndarray:
    """Flow field (H, W, 2) -> RGB uint8 via the colorwheel."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(np.max(rad), 1e-5)
    u, v = u / rad_max, v / rad_max

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[:, :, i] = np.floor(255 * col)
    return img
