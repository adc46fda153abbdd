"""Colour jitter (counterpart of ``mfcnet_tpu/ops/color.py``), with
``torchvision.transforms.functional``'s blend formulas on float images.

Images are float in [0, 1], channel-first ``(..., 3, H, W)`` RGB (the JAX
functions take ``(..., H, W, 3)``); every op clamps its output to [0, 1]
as torchvision's tensor backend does. ``factor`` is a scalar or a tensor
that broadcasts against the image (one factor per frame:
``(..., 1, 1, 1)``). The train augmentation applies brightness, then
contrast, then saturation (reference src/dataloader_multiframe.py:74-95).
"""

from __future__ import annotations

import torch

#: ITU-R 601-2 luma weights of torchvision's rgb_to_grayscale
LUMA = (0.2989, 0.587, 0.114)


def _blend(img1, img2, ratio):
    """ratio * img1 + (1 - ratio) * img2, clamped to [0, 1]."""
    return (ratio * img1 + (1.0 - ratio) * img2).clamp(0.0, 1.0)


def grayscale(img):
    """(..., 3, H, W) -> (..., 1, H, W) luma."""
    luma = torch.tensor(LUMA, dtype=img.dtype, device=img.device)
    return (img * luma.view(3, 1, 1)).sum(dim=-3, keepdim=True)


def adjust_brightness(img, factor):
    """img * factor, clamped."""
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    """Blend with the mean of each image's grayscale conversion."""
    mean = grayscale(img).mean(dim=(-2, -1), keepdim=True)
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    """Blend with the per-pixel grayscale image."""
    return _blend(img, grayscale(img), factor)
