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
import torch.nn.functional as F
from torch import nn

VGG11_STAGES = ((64,), (128,), (256, 256), (512, 512), (512, 512))
VGG16_STAGES = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)


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


class _BatchNormTrain(torch.autograd.Function):
    """flax's train-mode normalization (``flax/linen/normalization.py::
    _normalize``): the batch mean and biased variance E[y^2] - E[y]^2
    (clamped at 0) over (N, H, W) in float32 (float64 for a float64 y);
    (y - mean) * (rsqrt(var + eps) * scale) + bias in that type, rounded
    once to y's type. The backward is PyTorch's batch-norm backward on the
    saved input and statistics, so the graph keeps y and two vectors, not
    float32 copies of y."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps):
        acc = torch.promote_types(y.dtype, torch.float32)
        yf = y.to(acc)
        mean = yf.mean(dim=(0, 2, 3))
        var = ((yf * yf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        out = ((yf - mean.view(1, -1, 1, 1))
               * (invstd * weight.to(acc)).view(1, -1, 1, 1)
               + bias.to(acc).view(1, -1, 1, 1)).to(y.dtype)
        ctx.save_for_backward(y, weight, mean, invstd)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        y, weight, mean, invstd = ctx.saved_tensors
        gy, gw, gb = torch.ops.aten.native_batch_norm_backward(
            g.contiguous(), y, weight.to(mean.dtype), None, None, mean,
            invstd, True, ctx.eps, [True, True, True])
        return gy, gw.to(weight.dtype), gb.to(weight.dtype), None


def batch_norm_train(y, bn: nn.BatchNorm2d):
    """Train-mode batch norm of the JAX package's flax modules, not
    ``nn.BatchNorm2d``'s: statistics in float32, normalization in float32
    (float64 for float64 inputs) rounded once to the promoted type of y
    and the BN parameters (bf16 under a bf16 step), as flax computes it;
    the running statistics become 0.9 * running + 0.1 * batch with the
    biased variance (PyTorch stores the unbiased one, which gives another
    eval model after the first step). A batch of one position per channel
    gives variance 0 (``nn.BatchNorm2d`` raises there)."""
    dt = torch.promote_types(y.dtype, bn.weight.dtype)
    dt = torch.promote_types(dt, bn.bias.dtype)
    out, mean, var = _BatchNormTrain.apply(y.to(dt), bn.weight, bn.bias,
                                           bn.eps)
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
    ``generator`` (set by the train step, :func:`use_generator`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
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
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def use_generator(model: nn.Module, generator):
    """Let every :class:`Dropout` and :class:`DropPath` of ``model`` draw
    from ``generator``; returns how many there are."""
    mods = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in mods:
        m.generator = generator
    return len(mods)


def log_softmax_channels(x):
    """log_softmax over the channel axis of NCHW."""
    return F.log_softmax(x, dim=1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
