"""TAPNet's motion-prior attention maps (counterpart of
``mfcnet_tpu/data/attmap.py``; reference src/dataloader.py:20-76).

The previous frame's attention map is carried along the optical flow to
the current frame, then grey-dilated over 10x10 pixels. Three forms, as
in the JAX package:

  * :func:`cal_attmap_np`, the reference's numpy form (a forward warp by
    fancy-indexed assignment, then ``scipy.ndimage.grey_dilation``);
  * :func:`cal_attmap_scatter`, the same function in torch on a batch,
    bit for bit: every source proposes its row-major index to its target,
    the largest (the last writer of the assignment) wins;
  * :func:`cal_attmap_batched`, the device approximation: a backward warp
    by the negated flow (``ops/warp.py::flow_warp``, the ``mfc_flow_warp``
    kernel on the card), then a 10x10 max filter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mfcnet_tpu_torch.ops.warp import flow_warp


def cal_attmap_np(attmap: np.ndarray, optflow: np.ndarray) -> np.ndarray:
    """Forward-warp ``attmap`` (H, W) by ``optflow`` (H, W, 2), (dx, dy),
    then a 10x10 grey dilation. Each source pixel (y, x) writes its value
    to (y + dy, x + dx) rounded half to even and clipped to the image
    (np.clip in the reference, src/dataloader.py:69-70): flow off the
    border writes to the edge, and of several sources the last in
    row-major order wins."""
    from scipy import ndimage

    H, W = attmap.shape
    ys, xs = np.mgrid[:H, :W]
    ny = np.clip(np.rint(ys + optflow[..., 1]).astype(np.int64), 0, H - 1)
    nx = np.clip(np.rint(xs + optflow[..., 0]).astype(np.int64), 0, W - 1)
    out = np.zeros_like(attmap)
    out[ny.ravel(), nx.ravel()] = attmap[ys.ravel(), xs.ravel()]
    return ndimage.grey_dilation(out, size=(10, 10))


def max_filter_10(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> the max over each pixel's window [i-4, i+5] x [j-4,
    j+5] (scipy's footprint for an even size 10, flax's ``SAME`` padding
    (4, 5)), the outside at -inf."""
    x = F.pad(x[:, None], (4, 5, 4, 5), value=float("-inf"))
    return F.max_pool2d(x, 10, stride=1)[:, 0]


def cal_attmap_scatter(attmaps: torch.Tensor,
                       optflows: torch.Tensor) -> torch.Tensor:
    """:func:`cal_attmap_np` on a batch, bit for bit: attmaps (B, H, W),
    optflows (B, H, W, 2) with (dx, dy) channels. The targets are
    rounded in float64 (numpy adds the int64 grid to the float32 flow in
    float64); each source proposes its row-major index to its target and
    ``scatter_reduce(amax)`` keeps the last writer; a gather reads its
    value (0 where nothing lands)."""
    B, H, W = attmaps.shape
    n = H * W
    dev = attmaps.device
    ys = torch.arange(H, device=dev, dtype=torch.float64).view(1, H, 1)
    xs = torch.arange(W, device=dev, dtype=torch.float64).view(1, 1, W)
    flow = optflows.to(torch.float64)
    ny = torch.round(ys + flow[..., 1]).clamp(0, H - 1).long()
    nx = torch.round(xs + flow[..., 0]).clamp(0, W - 1).long()
    tgt = (ny * W + nx).reshape(B, n)
    src = torch.arange(n, device=dev).expand(B, n)
    win = torch.full((B, n), -1, dtype=torch.long, device=dev).scatter_reduce(
        1, tgt, src, "amax", include_self=False)
    vals = torch.gather(attmaps.reshape(B, n), 1, win.clamp_min(0))
    out = torch.where(win >= 0, vals, torch.zeros_like(vals))
    return max_filter_10(out.reshape(B, H, W))


def cal_attmap_batched(attmaps: torch.Tensor,
                       optflows: torch.Tensor) -> torch.Tensor:
    """The device approximation of :func:`cal_attmap_np`: attmaps
    (B, H, W) sampled at (x - dx, y - dy) (a bilinear backward warp by the
    negated flow, the identity grid, align_corners True, zero outside),
    then the 10x10 max filter. On CUDA tensors the warp is the
    ``mfc_flow_warp`` kernel."""
    warped = flow_warp(attmaps[:, None], -optflows.permute(0, 3, 1, 2))
    return max_filter_10(warped[:, 0])
