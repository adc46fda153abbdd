"""Middlebury ``.flo`` files (counterpart of ``read_flo``/``write_flo`` in
``mfcnet_tpu/data/masks.py``): the port's own copy, numpy only."""

from __future__ import annotations

import numpy as np


def read_flo(path) -> np.ndarray:
    """Standard Middlebury .flo reader (magic + W, H header) -> (H, W, 2)
    float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or abs(magic[0] - 202021.25) > 1e-3:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray):
    """Write Middlebury .flo ("PIEH" magic + W, H header; reference
    scripts/generate_opticalflow_unflow.py:114-115)."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([80, 73, 69, 72], np.uint8).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
