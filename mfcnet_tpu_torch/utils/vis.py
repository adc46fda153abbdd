"""Overlay rendering (counterpart of ``mfcnet_tpu/utils/vis.py``; reference
utils/vis_utils.py). ``cv2`` is imported inside the function."""

from __future__ import annotations

import numpy as np


def mask_overlay(image, mask, color=(0, 255, 0), wt=0.5):
    """Weighted color overlay where mask>0 (utils/vis_utils.py:44-55)."""
    import cv2

    colored = (np.dstack([mask] * 3) * np.asarray(color)).astype(np.uint8)
    blended = cv2.addWeighted(colored, wt, image, 1 - wt, 0.0)
    out = image.copy()
    sel = colored[:, :, 1] > 0
    out[sel] = blended[sel]
    return out
