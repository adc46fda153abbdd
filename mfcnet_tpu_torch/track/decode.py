"""Host-side keypoint decoding -- exact-parity path (OpenCV/scipy).

The port's own copy of ``mfcnet_tpu/track/decode.py`` (the port imports
nothing of the JAX package): the reference's contour/local-maxima decode
(utils/localization_utils_v2.py and the helpers in
scripts/test_multiframe_segmentation_on_videos_v3.py:29-59). The
on-device decode lives in track/decode_device.py; this module is the
ground truth it is tested against. ``cv2`` is imported inside the
functions that need it, so importing this module needs no OpenCV.

The contour functions take ``opencv=False`` to give OpenCV's results
from scipy and numpy alone (:func:`_scipy_contours`): the device
decode's re-decode of a tied side runs where OpenCV may be absent.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np

#: OpenCV's 1/6 in contourMoments (m10 = a10 * db1_6)
_SIXTH = 0.16666666666666666666666666666667


class _Contour(NamedTuple):
    """One external contour: ``cv2.contourArea``, the spatial moments
    m00/m10/m01 of ``cv2.moments``, the first vertex (x, y), and
    ``paint(selector)``, which fills it with 255 as ``cv2.drawContours(...,
    thickness=cv2.FILLED)`` does."""

    area: float
    m00: float
    m10: float
    m01: float
    first: Tuple[int, int]
    paint: Callable[[np.ndarray], None]


def _opencv_contours(mask: np.ndarray) -> List[_Contour]:
    import cv2

    contours, _ = cv2.findContours(
        mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    out = []
    for c in contours:
        m = cv2.moments(c)
        out.append(_Contour(
            cv2.contourArea(c), m["m00"], m["m10"], m["m01"],
            (c[0][0][0], c[0][0][1]),
            lambda sel, c=c: cv2.drawContours(sel, [c], 0, (255,),
                                              thickness=cv2.FILLED),
        ))
    return out


def _scipy_contours(mask: np.ndarray) -> List[_Contour]:
    """``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` without OpenCV.

    An external contour is the outer border of an 8-connected component
    of ``mask != 0`` that lies in no hole (4-connected background) of
    another. Its polygon runs through the centres of the border pixels,
    so it encloses the component with its holes filled, F. Over each 2x2
    block of pixel centres, the polygon holds the whole unit square when
    all four pixels are in F, the triangle of the three when three are,
    and nothing otherwise: the area and first moments are sums of those
    pieces, kept as the integers 2*area and 6*moment that OpenCV's
    Green's-theorem sums give, and scaled as OpenCV scales them. The
    first vertex is the component's first pixel in raster order;
    contours come in findContours' order, that of their first vertices
    reversed.
    """
    from scipy import ndimage

    cross = ndimage.generate_binary_structure(2, 1)
    fg = np.asarray(mask) != 0
    rows, cols = np.flatnonzero(fg.any(1)), np.flatnonzero(fg.any(0))
    if rows.size == 0:
        return []
    r0, c0 = int(rows[0]), int(cols[0])
    fg = fg[r0:rows[-1] + 1, c0:cols[-1] + 1]
    lab, _ = ndimage.label(fg, structure=np.ones((3, 3), bool))
    outside, _ = ndimage.label(np.pad(~fg, 1, constant_values=True),
                               structure=cross)
    out = []
    for k, (si, sj) in enumerate(ndimage.find_objects(lab), start=1):
        comp = lab[si, sj] == k
        top = int(np.argmax(comp[0]))
        i0, j0 = si.start, sj.start
        # the pixel left of the first one lies in the background that
        # surrounds the component (padded coordinates)
        if outside[i0 + 1, j0 + top] != outside[0, 0]:
            continue
        bg, _ = ndimage.label(np.pad(~comp, 1, constant_values=True),
                              structure=cross)
        filled = bg != bg[0, 0]
        f = filled.astype(np.int64)
        a, b, c, d = f[:-1, :-1], f[:-1, 1:], f[1:, :-1], f[1:, 1:]
        n = a + b + c + d
        full, tri = n == 4, n == 3
        y = np.arange(n.shape[0])[:, None] + (r0 + i0 - 1)
        x = np.arange(n.shape[1])[None, :] + (c0 + j0 - 1)
        # a full square's 6*moment is 6x+3; a triangle's is the sum of
        # its three corners
        x6 = np.where(full, 6 * x + 3, 0) + np.where(
            tri, (a + c) * x + (b + d) * (x + 1), 0)
        y6 = np.where(full, 6 * y + 3, 0) + np.where(
            tri, (a + b) * y + (c + d) * (y + 1), 0)
        a2 = 2 * int(full.sum()) + int(tri.sum())
        m = ((a2 * 0.5, int(x6.sum()) * _SIXTH, int(y6.sum()) * _SIXTH)
             if a2 else (0.0, 0.0, 0.0))
        sl = (slice(r0 + i0, r0 + si.stop), slice(c0 + j0, c0 + sj.stop))

        def paint(sel, sl=sl, inside=filled[1:-1, 1:-1]):
            sel[sl][inside] = 255

        out.append(_Contour(a2 * 0.5, *m, (c0 + j0 + top, r0 + i0), paint))
    out.sort(key=lambda c: c.first[::-1], reverse=True)
    return out


def _largest(mask, k, opencv):
    cnts = (_opencv_contours if opencv else _scipy_contours)(mask)
    return sorted(cnts, key=lambda c: c.area, reverse=True)[:k]


def create_circular_mask(h: int, w: int, center=None, radius=None):
    """utils/localization_utils_v2.py:5-13."""
    if center is None:
        center = (int(w / 2), int(h / 2))
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    Y, X = np.ogrid[:h, :w]
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    return dist <= radius


def calc_centroids(mask: np.ndarray, opencv: bool = True
                   ) -> Tuple[List[int], List[int]]:
    """Top-2 contour centroids by area (utils/localization_utils_v2.py:15-33).

    Degenerate contours (zero moment) fall back to their first vertex.
    """
    cx, cy = [], []
    for c in _largest(mask, 2, opencv):
        if c.m00 == 0:
            cx.append(c.first[0])
            cy.append(c.first[1])
        else:
            cx.append(int(c.m10 / c.m00))
            cy.append(int(c.m01 / c.m00))
    return cx, cy


def determine_local_maxima_and_estimate_centroids(
    heatmap: np.ndarray, blob: np.ndarray, footprint: np.ndarray,
    opencv: bool = True,
):
    """Gaussian(σ=4) smooth -> footprint local-max ∧ blob -> centroids
    (utils/localization_utils_v2.py:35-40)."""
    from scipy import ndimage

    smoothed = ndimage.gaussian_filter(heatmap, 4)
    localmax = ndimage.maximum_filter(smoothed, footprint=footprint) == smoothed
    loc = blob & localmax
    return calc_centroids(255 * loc.astype(np.uint8), opencv)


def refine_tip_segmentation(mask: np.ndarray, area_threshold: float,
                            opencv: bool = True):
    """Keep only the top-2 contours with area >= threshold
    (scripts/test_multiframe_segmentation_on_videos_v3.py:32-42)."""
    selector = np.zeros_like(mask)
    for c in _largest(mask, 2, opencv):
        if c.area >= area_threshold:
            c.paint(selector)
    # cv2.bitwise_and(mask, mask, mask=selector): the selector is 0 or 255
    return mask & selector


def calc_base_centroid(mask: np.ndarray, area_threshold: float,
                       opencv: bool = True):
    """Largest-contour centroid gated by area
    (scripts/test_multiframe_segmentation_on_videos_v3.py:45-59)."""
    cx, cy = [], []
    for c in _largest(mask, 1, opencv):
        if c.area < area_threshold or c.m00 == 0:
            continue
        cx.append(int(c.m10 / c.m00))
        cy.append(int(c.m01 / c.m00))
    return cx, cy


def compute_distance(x1, y1, x2, y2) -> float:
    return float(np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2))
