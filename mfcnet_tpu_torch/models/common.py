"""Shared building blocks (counterpart of ``mfcnet_tpu/models/common.py``).

Modules run NCHW inside, PyTorch's own layout, and carry the reference's
``state_dict`` key names (``conv``, ``block.0.conv``, ``block.1``), so
reference ``.pth`` checkpoints load directly. The model-level entry
points convert from and to the JAX package's NHWC layout.

:class:`BatchNorm2d` is the batch norm of every model of the port: flax's
``BatchNorm`` rules under PyTorch's module and key names;
:class:`GroupNorm` is flax's ``GroupNorm`` in the same way, and
:class:`WSConv2d` the JAX ResUNet's weight-standardized convolution.
:class:`Dropout`
and :class:`DropPath` are flax's ``Dropout`` and the JAX SegFormer's
stochastic depth, drawing from a generator that the train step hands them
(:func:`use_generator`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mfcnet_tpu_torch.parallel.dist import group_world, rank_rows

VGG11_STAGES = ((64,), (128,), (256, 256), (512, 512), (512, 512))
VGG16_STAGES = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)


def run_segment(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, while gradients are enabled, as one
    rematerialized segment (the JAX package's ``nn.remat``):
    ``torch.utils.checkpoint`` without reentry keeps only the segment's
    inputs and recomputes its activations in the backward pass, restoring
    the random state first. Parameter names and forward values do not
    change."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ConvReLU(nn.Module):
    """Conv3x3 (padding 1) + ReLU (reference models/ternausnet.py:14-23)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.activation = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.activation(self.conv(x))


class DecoderBlockDeconv(nn.Module):
    """ConvReLU(mid) -> ConvTranspose2d(out, k4 s2 p1) -> ReLU
    (reference models/ternausnet.py:25-43, is_deconv=True)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(
            ConvReLU(in_ch, mid_ch),
            nn.ConvTranspose2d(mid_ch, out_ch, kernel_size=4, stride=2,
                               padding=1),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        return self.block(x)


def vgg_features(stage_convs: Sequence[Sequence[int]], in_ch: int = 3):
    """torchvision-style VGG ``features``: per stage its convs (each
    followed by ReLU) then a 2x2 max-pool, so VGG16 stages give
    torchvision's layer indices (convs at 0, 2, 5, 7, 10, ...)."""
    layers = []
    for stage in stage_convs:
        for ch in stage:
            layers += [nn.Conv2d(in_ch, ch, 3, padding=1),
                       nn.ReLU(inplace=True)]
            in_ch = ch
        layers.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*layers)


BN_EPS = 1e-5
#: the running-statistics update of flax's BatchNorm(momentum=0.9):
#: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.1


def _batch_stats(yf):
    """Per-channel (mean, biased variance clamped at 0, count) of ``yf`` over
    (N, H, W): of this process's batch, or under a process group of world
    > 1 of the global batch, from the float Σy and Σy² summed over the
    group (``parallel/dist.py``; the JAX package's batch reductions are
    global under a sharded ``jit``). Every rank holds a batch of the same
    shape (the sharded loader and ``rank_rows`` split the global batch
    evenly), so the global count is the local one times the world."""
    world = group_world()
    count = yf.numel() // yf.shape[1]
    if world == 1:
        mean = yf.mean(dim=(0, 2, 3))
        var = ((yf * yf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        return mean, var, count
    count *= world
    sums = torch.stack([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))])
    dist.all_reduce(sums)
    mean = sums[0] / count
    var = (sums[1] / count - mean * mean).clamp_min(0.0)
    return mean, var, count


class _BatchNormTrain(torch.autograd.Function):
    """flax's train-mode normalization (``flax/linen/normalization.py::
    _normalize``): the batch mean and biased variance E[y^2] - E[y]^2
    (clamped at 0) over (N, H, W) in float32 (float64 for a float64 y);
    (y - mean) * (rsqrt(var + eps) * scale) + bias in that type, rounded
    once to y's type. The backward is PyTorch's batch-norm backward on the
    saved input and statistics, so the graph keeps y and two vectors, not
    float32 copies of y. Under a process group of world > 1 the statistics
    are the global batch's (:func:`_batch_stats`) and the backward sums its
    two per-channel gradient sums over the group as well; the parameters'
    gradients stay this rank's, which ``DistributedDataParallel`` then
    reduces. Returns (out, mean, var, count), count the (global) positions
    per channel."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps):
        acc = torch.promote_types(y.dtype, torch.float32)
        yf = y.to(acc)
        mean, var, count = _batch_stats(yf)
        invstd = torch.rsqrt(var + eps)
        out = ((yf - mean.view(1, -1, 1, 1))
               * (invstd * weight.to(acc)).view(1, -1, 1, 1)
               + bias.to(acc).view(1, -1, 1, 1)).to(y.dtype)
        ctx.save_for_backward(y, weight, mean, invstd)
        ctx.eps, ctx.count = eps, count
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var, count

    @staticmethod
    def backward(ctx, g, _gm, _gv, _gn):
        y, weight, mean, invstd = ctx.saved_tensors
        if group_world() == 1:
            gy, gw, gb = torch.ops.aten.native_batch_norm_backward(
                g.contiguous(), y, weight.to(mean.dtype), None, None, mean,
                invstd, True, ctx.eps, [True, True, True])
            return gy, gw.to(weight.dtype), gb.to(weight.dtype), None
        gf = g.to(mean.dtype)
        xmu = y.to(mean.dtype) - mean.view(1, -1, 1, 1)
        local = torch.stack([gf.sum(dim=(0, 2, 3)),
                             (gf * xmu).sum(dim=(0, 2, 3))])
        gb, gw = local[0].clone(), local[1] * invstd
        dist.all_reduce(local)
        mean_dy, mean_dy_xmu = local / ctx.count
        c = lambda v: v.view(1, -1, 1, 1)  # noqa: E731
        gy = (gf - c(mean_dy) - xmu * c(invstd * invstd * mean_dy_xmu)) \
            * c(invstd * weight.to(mean.dtype))
        return (gy.to(y.dtype), gw.to(weight.dtype), gb.to(weight.dtype),
                None)


def batch_norm_train(y, bn: nn.BatchNorm2d, unbiased: bool = False):
    """Train-mode batch norm of the JAX package's flax modules, not
    ``nn.BatchNorm2d``'s: statistics in float32, normalization in float32
    (float64 for float64 inputs) rounded once to the promoted type of y
    and the BN parameters (bf16 under a bf16 step), as flax computes it;
    the running statistics become 0.9 * running + 0.1 * batch with the
    biased variance (PyTorch stores the unbiased one, which gives another
    eval model after the first step; ``unbiased`` stores it, times count /
    (count - 1), as the JAX package's ABN does). A batch of one position
    per channel gives variance 0 (``nn.BatchNorm2d`` raises there). Under
    a process group of world > 1 the statistics are the global batch's,
    and so are the running statistics, on every rank alike."""
    dt = torch.promote_types(y.dtype, bn.weight.dtype)
    dt = torch.promote_types(dt, bn.bias.dtype)
    out, mean, var, count = _BatchNormTrain.apply(y.to(dt), bn.weight,
                                                  bn.bias, bn.eps)
    if unbiased and count > 1:
        var = var * (count / (count - 1))
    with torch.no_grad():
        keep = 1.0 - BN_MOMENTUM
        bn.running_mean.copy_(keep * bn.running_mean + BN_MOMENTUM * mean)
        bn.running_var.copy_(keep * bn.running_var + BN_MOMENTUM * var)
    return out


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its key names, eps 1e-5) under flax's rules:
    train mode is :func:`batch_norm_train`; eval mode normalizes by the
    running statistics in their type (float32 statistics: in float32,
    rounded once to the input's type, as flax promotes; the bf16 tracker
    casts them to bf16 with the rest of the model, as the JAX tracker
    does)."""

    def forward(self, x):
        if self.training:
            return batch_norm_train(x, self)
        dt = torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        pt = torch.promote_types(dt, self.running_mean.dtype)
        return F.batch_norm(
            x.to(dt), self.running_mean.to(pt), self.running_var.to(pt),
            self.weight.to(pt), self.bias.to(pt), False, 0.0, self.eps)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (its key names, eps 1e-5) under flax's
    ``GroupNorm`` rules: the mean and variance E[y^2] - E[y]^2 (clamped at
    0) of each sample's group over (channels of the group, H, W) in float32
    (float64 for float64 inputs), (y - mean) * (rsqrt(var + eps) * weight)
    + bias in that type, rounded once to the promoted type of y and the
    parameters."""

    def forward(self, x):
        dt = torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        acc = torch.promote_types(dt, torch.float32)
        B, Cn, Hh, Ww = x.shape
        G = self.num_groups
        g = x.to(acc).reshape(B, G, -1)
        mean = g.mean(dim=2, keepdim=True)
        var = ((g * g).mean(dim=2, keepdim=True) - mean * mean).clamp_min(0)
        mul = torch.rsqrt(var + self.eps).expand(B, G, Cn // G).reshape(
            B, Cn, 1, 1) * self.weight.to(acc).view(1, Cn, 1, 1)
        y = (g - mean).reshape(B, Cn, Hh, Ww) * mul
        return (y + self.bias.to(acc).view(1, Cn, 1, 1)).to(dt)


class WSConv2d(nn.Conv2d):
    """Weight-standardized ``Conv2d`` (the JAX ResUNet's ``WSConv``,
    reference models/resunet.py:51-64): each output channel's weight
    minus its mean, over the biased standard deviation across (in, kh,
    kw), computed in float32 (float64 for a float64 weight) and cast to
    the input's type. The JAX module's eps follows the input's type: 1e-5
    for float32, 1e-3 for any other (bfloat16, and float64 too), kept."""

    def forward(self, x):
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        w = self.weight.to(torch.promote_types(self.weight.dtype,
                                               torch.float32))
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the draws come from
    ``generator`` (set by the train step, :func:`use_generator`). With
    ``rows`` (rank, world), world > 1, the draws are those of the global
    batch of world times this batch, of which this rank takes its rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None
        self.rows = (0, 1)

    def _uniform(self, shape, device):
        rank, world = self.rows
        n = shape[0] * world
        u = torch.rand((n,) + tuple(shape[1:]), generator=self.generator,
                       device=device)
        return u[rank_rows(n, rank, world)]

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = self._uniform(x.shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(Dropout):
    """Stochastic depth (timm ``DropPath``, the JAX SegFormer's
    ``_drop_path``): in train mode a residual branch is dropped per
    sample with probability ``rate`` and kept ones scaled by 1 / (1 -
    rate)."""

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = self._uniform(shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def use_generator(model: nn.Module, generator, rows=(0, 1)):
    """Let every :class:`Dropout` and :class:`DropPath` of ``model`` draw
    from ``generator``, at ``rows`` (rank, world) of the global batch;
    returns how many there are."""
    mods = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in mods:
        m.generator = generator
        m.rows = tuple(rows)
    return len(mods)


def log_softmax_channels(x):
    """log_softmax over the channel axis of NCHW."""
    return F.log_softmax(x, dim=1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
