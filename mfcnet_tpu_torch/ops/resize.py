"""Image resize (counterpart of ``mfcnet_tpu/ops/resize.py``), with
``torch.nn.functional.interpolate`` semantics.

The spatial axes are the last two (PyTorch's layout, which the tracker's
engine keeps); the JAX functions resize axes (-3, -2) of NHWC arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output position: src = floor(dst * in/out), in
    float64 as the JAX package computes it."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.floor(dst * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


@functools.lru_cache(maxsize=64)
def _repeat_factor(in_size: int, out_size: int) -> int:
    """k where every output position's source is dst // k (an integer
    upscale whose float64 index is exact), else 0."""
    k = out_size // in_size
    if k < 1 or k * in_size != out_size:
        return 0
    exact = np.array_equal(_nearest_index(in_size, out_size),
                           np.arange(out_size) // k)
    return k if exact else 0


def resize_nearest(img, out_h: int, out_w: int):
    """Nearest-neighbour resize of (..., H, W). An integer upscale (the
    UNets' 2x) repeats each pixel k x l times on the device; any other size
    gathers by an index computed there (:func:`_nearest_index_on`).
    Neither copies from the host, so both capture into a CUDA graph."""
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    k, l = _repeat_factor(in_h, out_h), _repeat_factor(in_w, out_w)
    if k and l:
        lead = img.shape[:-2]
        return img[..., :, None, :, None].expand(
            *lead, in_h, k, in_w, l).reshape(*lead, out_h, out_w)
    rows = _nearest_index_on(in_h, out_h, img.device)
    cols = _nearest_index_on(in_w, out_w, img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def _nearest_index_on(in_size: int, out_size: int, device) -> torch.Tensor:
    """:func:`_nearest_index` computed on ``device``: the same float64
    product and floor, so the same integers, with nothing copied from the
    host, so that it captures into a CUDA graph (the tracker's
    half-resolution downsample)."""
    dst = torch.arange(out_size, dtype=torch.float64, device=device)
    src = torch.floor(dst * (in_size / out_size)).to(torch.int64)
    return src.clamp_(0, in_size - 1)


def resize_bilinear(img, out_h: int, out_w: int, align_corners: bool = False):
    """Bilinear resize of (N, C, H, W), antialias off; interpolates in
    float32 and returns the input's dtype."""
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    out = F.interpolate(img.float(), size=(out_h, out_w), mode="bilinear",
                        align_corners=align_corners)
    return out.to(img.dtype)
