"""Nearest rotation with zero fill (counterpart of
``mfcnet_tpu/ops/rotate.py``), matching
``torchvision.transforms.functional.rotate`` with its default NEAREST
interpolation.

Output pixel p (relative to the exact centre c = ((W-1)/2, (H-1)/2))
samples the source at R(-angle) (p - c) + c, rounded half to even
(``torch.round``, as ``jnp.round``); samples outside the image are 0.
The spatial axes are the last two; each image of the batch has its own
angle (the reference rotates frames, mask and depth of one sample by the
same angle, src/dataloader_multiframe.py:57-72).
"""

from __future__ import annotations

import torch


def rotation_index(angle_deg, H: int, W: int):
    """Source pixel of every output pixel for angles ``angle_deg`` (B,)
    in degrees, counter-clockwise positive: ``(idx, valid)``, each
    (B, H, W); idx is the flat source index y * W + x (clamped where not
    valid). The coordinates are computed in float32 in the JAX code's
    order."""
    dev = angle_deg.device
    theta = torch.deg2rad(angle_deg.to(torch.float32)).view(-1, 1, 1)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1) - cy
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W) - cx
    ix = torch.round(cos * xx + sin * yy + cx).to(torch.int64)
    iy = torch.round(-sin * xx + cos * yy + cy).to(torch.int64)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    return idx, valid


def rotate_nearest(img, angle_deg):
    """Rotate ``img`` (B, ..., H, W) by ``angle_deg`` (B,) degrees,
    nearest, zero fill; any dtype."""
    B, H, W = img.shape[0], img.shape[-2], img.shape[-1]
    idx, valid = rotation_index(angle_deg, H, W)
    flat = img.reshape(B, -1, H * W)
    out = flat.gather(2, idx.view(B, 1, H * W).expand(-1, flat.shape[1], -1))
    out = out * valid.view(B, 1, H * W).to(out.dtype)
    return out.reshape(img.shape)
