"""MFCNet — the multi-frame fusion head and its wrappers (counterpart of
``mfcnet_tpu/models/mfcnet.py``; reference models/multiframe_model.py).

The Basic variant: the per-frame class maps of T frames (newest first)
are stacked on the channel axis and fused by a 4-conv head. With optical
flow the earlier frames' maps (and depth maps) are first warped into the
newest frame (``ops/warp.py::flow_warp``, on the reference's cropped
576x720 grid); the flow channels themselves do not reach the head. With
depth inputs the T depth maps follow the class maps.

The Large variant warps nothing: the T class maps, the T-1 raw flows
(channels in (i, xy) order) and the T depth maps go into a wider head in
that order, JAX's NHWC ``[seg_t..., flow_i..., depth_t...]``. Its head is
sized at construction (the JAX head is sized lazily by flax at init), so
it is built for the inputs it will be given and refuses others.

Module names follow the reference (``base_model``,
``multiframe_net.multiframe_net.{0..9}``) for both variants.

The head's train mode is the JAX head's (biased batch variance, JAX's
running-statistics update); eval mode uses the running statistics, as
the tracker does. Public methods take and return the JAX package's NHWC
layout;
``base_nchw``/``fuse_nchw`` are the NCHW forms the tracker's engine
keeps its ring buffers in.
"""

from __future__ import annotations

import torch
from torch import nn

from mfcnet_tpu_torch.models.common import nchw_to_nhwc, nhwc_to_nchw
from mfcnet_tpu_torch.ops.warp import flow_warp

# The reference builds its warp mesh grid at a fixed 576x720 and crops it
# (models/multiframe_model.py:172-185); kept for checkpoint parity.
REFERENCE_GRID_HW = (576, 720)


BN_EPS = 1e-5
#: the JAX head's running-statistics update: running = 0.9 * running + 0.1
#: * batch
BN_MOMENTUM = 0.1


def batch_norm_train(y, bn: nn.BatchNorm2d):
    """Train-mode batch norm of the JAX head (``mfcnet_tpu/models/
    mfcnet.py:116-147``), not ``nn.BatchNorm2d``'s: float32 batch mean and
    the biased variance E[y^2] - E[y]^2 (clamped at 0) over (N, H, W); the
    running statistics become 0.9 * running + 0.1 * batch, with the biased
    variance (PyTorch's BatchNorm stores the unbiased one, which gives
    another eval model after the first step); y normalized in the
    promoted type of y and the BN parameters (bf16 under a bf16 step)."""
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    var = ((yf * yf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        keep = 1.0 - BN_MOMENTUM
        bn.running_mean.copy_(keep * bn.running_mean + BN_MOMENTUM * mean)
        bn.running_var.copy_(keep * bn.running_var + BN_MOMENTUM * var)
    dt = torch.promote_types(y.dtype, bn.weight.dtype)

    def ch(v):
        return v.to(dt).view(1, -1, 1, 1)

    return ((y.to(dt) - ch(mean)) * torch.rsqrt(ch(var) + BN_EPS)
            * ch(bn.weight) + ch(bn.bias))


class MultiFrameHead(nn.Sequential):
    """Conv11x11(-> T*C, no bias) + BN + ReLU, 2 x [Conv3x3 + BN + ReLU],
    Conv1x1(-> C, no bias) (reference models/multiframe_model.py:62-73).
    In eval mode BN uses its running statistics; in train mode the JAX
    head's batch statistics (:func:`batch_norm_train`)."""

    def __init__(self, in_ch: int, num_classes: int, num_frames: int):
        tc = num_frames * num_classes
        super().__init__(
            nn.Conv2d(in_ch, tc, 11, padding=5, bias=False),
            nn.BatchNorm2d(tc),
            nn.ReLU(),
            nn.Conv2d(tc, tc, 3, padding=1, bias=False),
            nn.BatchNorm2d(tc),
            nn.ReLU(),
            nn.Conv2d(tc, tc, 3, padding=1, bias=False),
            nn.BatchNorm2d(tc),
            nn.ReLU(),
            nn.Conv2d(tc, num_classes, 1, bias=False),
        )

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        for mod in self:
            x = (batch_norm_train(x, mod) if isinstance(mod, nn.BatchNorm2d)
                 else mod(x))
        return x


class MultiFrameNet(nn.Module):
    """Fusion module. ``variant='basic'``: optional flow-warp alignment of
    the earlier frames' maps, then the head over class (and depth)
    channels; ``parity_grid`` reproduces the reference's 576x720 crop
    grid. ``variant='large'``: no warp; class, raw flow and depth channels
    all go into the head, which ``add_optflow_inputs`` and
    ``add_depth_inputs`` size (``parity_grid`` is unused)."""

    def __init__(self, num_classes: int, num_frames: int,
                 variant: str = "basic", add_depth_inputs: bool = False,
                 parity_grid: bool = True, add_optflow_inputs: bool = False):
        super().__init__()
        if variant not in ("basic", "large"):
            raise ValueError(f"unknown MFCNet variant: {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.parity_grid = parity_grid
        self.add_depth_inputs = add_depth_inputs
        self.add_optflow_inputs = add_optflow_inputs
        in_ch = num_frames * (num_classes + int(add_depth_inputs))
        if variant == "large":
            in_ch += 2 * (num_frames - 1) * int(add_optflow_inputs)
        self.multiframe_net = MultiFrameHead(in_ch, num_classes, num_frames)

    def _check_large_inputs(self, optflow, depth):
        """A Large head runs only on the inputs it was sized for."""
        for name, flag, built, given in (
                ("optflow", "add_optflow_inputs", self.add_optflow_inputs,
                 optflow is not None),
                ("depth", "add_depth_inputs", self.add_depth_inputs,
                 depth is not None)):
            if built and not given:
                raise ValueError(f"this Large head was built with {flag}="
                                 f"True and was called without {name}")
            if given and not built:
                raise ValueError(f"this Large head was built without {flag} "
                                 f"and was called with {name}")

    def forward(self, seg, optflow=None, depth=None):
        """seg: (B, T*C, H, W) stacked maps, newest frame first; optflow:
        optional (B, T-1, 2, H, W) flow of frames 1..T-1 in pixels (x, y);
        depth: optional (B, T, H, W) -> (B, C, H, W) fused logits."""
        B, _, H, W = seg.shape
        T, C = self.num_frames, self.num_classes
        if self.variant == "large":
            self._check_large_inputs(optflow, depth)
            parts = [seg]
            if optflow is not None:
                parts.append(optflow.reshape(B, 2 * (T - 1), H, W)
                             .to(seg.dtype))
            if depth is not None:
                parts.append(depth.to(seg.dtype))
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            return self.multiframe_net(x)
        parts = [seg]
        if depth is not None:
            parts.append(depth.to(seg.dtype))
        if optflow is not None:
            # all T-1 warps in one call over B*(T-1) maps of C (+1) channels
            maps = seg[:, C:].reshape(B, T - 1, C, H, W)
            if depth is not None:
                maps = torch.cat([maps, depth[:, 1:, None].to(seg.dtype)],
                                 dim=2)
            Cw = maps.shape[2]
            warped = flow_warp(
                maps.reshape(B * (T - 1), Cw, H, W),
                optflow.reshape(B * (T - 1), 2, H, W),
                grid_hw=REFERENCE_GRID_HW if self.parity_grid else None,
            ).reshape(B, T - 1, Cw, H, W)
            parts = [seg[:, :C],
                     warped[:, :, :C].reshape(B, (T - 1) * C, H, W)]
            if depth is not None:
                parts += [depth[:, :1].to(seg.dtype), warped[:, :, C]]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return self.multiframe_net(x)


class MultiFrameSegmenter(nn.Module):
    """Per-frame base model + MFCNet fusion (reference wrappers,
    models/multiframe_model.py:207-238). ``base_output='exp'`` turns the
    base's log-probabilities into probabilities (TernausNet)."""

    def __init__(self, base: nn.Module, num_classes: int, num_frames: int,
                 variant: str = "basic", base_output: str = "exp",
                 add_depth_inputs: bool = False, parity_grid: bool = True,
                 add_optflow_inputs: bool = False):
        super().__init__()
        if base_output != "exp":
            raise NotImplementedError(
                f"base_output {base_output!r}: only TernausNet bases are "
                "ported (ROADMAP.md Queue 1 item 10)"
            )
        self.base_model = base
        self.multiframe_net = MultiFrameNet(
            num_classes, num_frames, variant,
            add_depth_inputs=add_depth_inputs, parity_grid=parity_grid,
            add_optflow_inputs=add_optflow_inputs)
        self.num_classes = num_classes
        self.num_frames = num_frames

    def base_nchw(self, x):
        """(N, 3, H, W) normalized frames -> (N, C, H, W) probabilities."""
        return torch.exp(self.base_model(x))

    def fuse_nchw(self, seg, optflow=None, depth=None):
        """(B, T*C, H, W) per-frame maps, newest first (and optional
        (B, T-1, 2, H, W) flow, (B, T, H, W) depth) -> (B, C, H, W)."""
        return self.multiframe_net(seg, optflow=optflow, depth=depth)

    @staticmethod
    def _flow_depth_nchw(optflow, depth):
        if optflow is not None:
            optflow = optflow.permute(0, 1, 4, 2, 3)
        if depth is not None:
            depth = depth[..., 0]
        return optflow, depth

    def forward(self, frames, optflow=None, depth=None):
        """frames: (B, T, H, W, 3) normalized RGB, newest first; optflow:
        optional (B, T-1, H, W, 2); depth: optional (B, T, H, W, 1) ->
        (B, H, W, C) fused logits."""
        B, T, H, W, _ = frames.shape
        y = self.base_nchw(nhwc_to_nchw(frames.reshape(B * T, H, W, 3)))
        optflow, depth = self._flow_depth_nchw(optflow, depth)
        return nchw_to_nhwc(self.fuse_nchw(
            y.reshape(B, T * y.shape[1], H, W), optflow, depth))

    def base_forward(self, frames):
        """(B, H, W, 3) -> (B, H, W, C) per-frame probabilities."""
        return nchw_to_nhwc(self.base_nchw(nhwc_to_nchw(frames)))

    def fuse_precomputed(self, seg, optflow=None, depth=None):
        """Fusion head only, on precomputed per-frame maps
        (B, T, H, W, C) -> (B, H, W, C) logits (the incremental
        tracker's path: one base forward per new frame)."""
        B, T, H, W, C = seg.shape
        x = seg.permute(0, 1, 4, 2, 3).reshape(B, T * C, H, W)
        optflow, depth = self._flow_depth_nchw(optflow, depth)
        return nchw_to_nhwc(self.fuse_nchw(x, optflow, depth))
