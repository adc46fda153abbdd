"""Host-side keypoint decoding -- exact-parity path (OpenCV/scipy).

The port's own copy of ``mfcnet_tpu/track/decode.py`` (the port imports
nothing of the JAX package): the reference's contour/local-maxima decode
(utils/localization_utils_v2.py and the helpers in
scripts/test_multiframe_segmentation_on_videos_v3.py:29-59). The
on-device decode lives in track/decode_device.py; this module is the
ground truth it is tested against. ``cv2`` is imported inside the
functions that need it, so importing this module needs no OpenCV.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def create_circular_mask(h: int, w: int, center=None, radius=None):
    """utils/localization_utils_v2.py:5-13."""
    if center is None:
        center = (int(w / 2), int(h / 2))
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    Y, X = np.ogrid[:h, :w]
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    return dist <= radius


def calc_centroids(mask: np.ndarray) -> Tuple[List[int], List[int]]:
    """Top-2 contour centroids by area (utils/localization_utils_v2.py:15-33).

    Degenerate contours (zero moment) fall back to their first vertex.
    """
    import cv2

    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    cnts = sorted(contours, key=cv2.contourArea, reverse=True)[:2]
    cx, cy = [], []
    for c in cnts:
        m = cv2.moments(c)
        if m["m00"] == 0:
            cx.append(c[0][0][0])
            cy.append(c[0][0][1])
        else:
            cx.append(int(m["m10"] / m["m00"]))
            cy.append(int(m["m01"] / m["m00"]))
    return cx, cy


def determine_local_maxima_and_estimate_centroids(
    heatmap: np.ndarray, blob: np.ndarray, footprint: np.ndarray
):
    """Gaussian(σ=4) smooth -> footprint local-max ∧ blob -> centroids
    (utils/localization_utils_v2.py:35-40)."""
    from scipy import ndimage

    smoothed = ndimage.gaussian_filter(heatmap, 4)
    localmax = ndimage.maximum_filter(smoothed, footprint=footprint) == smoothed
    loc = blob & localmax
    return calc_centroids(255 * loc.astype(np.uint8))


def refine_tip_segmentation(mask: np.ndarray, area_threshold: float):
    """Keep only the top-2 contours with area >= threshold
    (scripts/test_multiframe_segmentation_on_videos_v3.py:32-42)."""
    import cv2

    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    contours = sorted(contours, key=cv2.contourArea, reverse=True)[:2]
    selector = np.zeros_like(mask)
    for c in contours:
        if cv2.contourArea(c) < area_threshold:
            continue
        cv2.drawContours(selector, [c], 0, (255,), thickness=cv2.FILLED)
    return cv2.bitwise_and(mask, mask, mask=selector)


def calc_base_centroid(mask: np.ndarray, area_threshold: float):
    """Largest-contour centroid gated by area
    (scripts/test_multiframe_segmentation_on_videos_v3.py:45-59)."""
    import cv2

    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    cnts = sorted(contours, key=cv2.contourArea, reverse=True)[:1]
    cx, cy = [], []
    for c in cnts:
        if cv2.contourArea(c) < area_threshold:
            continue
        m = cv2.moments(c)
        if m["m00"] == 0:
            continue
        cx.append(int(m["m10"] / m["m00"]))
        cy.append(int(m["m01"] / m["m00"]))
    return cx, cy


def compute_distance(x1, y1, x2, y2) -> float:
    return float(np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2))
