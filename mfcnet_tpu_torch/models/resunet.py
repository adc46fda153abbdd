"""ResUNet — diffusion-style residual U-Net (counterpart of
``mfcnet_tpu/models/resunet.py``; reference models/resunet.py:97-180,
``ResUnet_VB``). NCHW in and out; emits raw logits.

ResNet blocks of weight-standardized 3x3 convs (``WSConv2d``), GroupNorm
(flax's rules, ``GroupNorm``) and SiLU with a 1x1 residual where the width
changes; pixel-unshuffle downsampling (``F.pixel_unshuffle``, whose
channel order c*4 + p1*2 + p2 is the reference's einops ``Rearrange``)
and nearest 2x upsampling. The module tree is the reference's
(``init_conv``, ``downs.{i}.{0,1}``, ``mid_block``, ``ups.{i}.{0,1}``,
``final_res_block``, ``output_layer``; blocks ``block{1,2}.{proj,norm}``
and ``res_conv``), so its checkpoints load by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import GroupNorm, WSConv2d
from mfcnet_tpu_torch.ops.resize import resize_nearest


class Block(nn.Module):
    """WSConv3x3 + GroupNorm + SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.proj = WSConv2d(dim, dim_out, 3, padding=1)
        self.norm = GroupNorm(groups, dim_out)

    def forward(self, x):
        return F.silu(self.norm(self.proj(x)))


class ResnetBlock(nn.Module):
    """Two blocks plus the input, through a 1x1 conv where the width
    changes (reference models/resunet.py:68-96)."""

    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x):
        return self.block2(self.block1(x)) + self.res_conv(x)


class PixelUnshuffle(nn.Module):
    """(B, C, 2h, 2w) -> (B, 4C, h, w), channel c*4 + p1*2 + p2."""

    def forward(self, x):
        return F.pixel_unshuffle(x, 2)


class Upsample(nn.Module):
    """Nearest 2x."""

    def forward(self, x):
        return resize_nearest(x, x.shape[-2] * 2, x.shape[-1] * 2)


class ResUNetVB(nn.Module):
    """``ResUnet_VB(channels, dim, out_dim, dim_mults, groups)``. Input H,
    W must be divisible by 2^(len(dim_mults) - 1)."""

    def __init__(self, out_channels: int, dim: int = 16,
                 dim_mults=(1, 2, 4, 8), groups: int = 8, in_ch: int = 3):
        super().__init__()
        self.init_conv = nn.Conv2d(in_ch, dim, 7, padding=3)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        self.downs = nn.ModuleList(
            nn.ModuleList([
                ResnetBlock(d_in, d_in, groups),
                nn.Sequential(PixelUnshuffle(), nn.Conv2d(d_in * 4, d_out, 1))
                if i < n - 1 else nn.Conv2d(d_in, d_out, 3, padding=1)])
            for i, (d_in, d_out) in enumerate(in_out))
        self.mid_block = ResnetBlock(dims[-1], dims[-1], groups)
        self.ups = nn.ModuleList(
            nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, groups),
                nn.Sequential(Upsample(), nn.Conv2d(d_out, d_in, 3, padding=1))
                if i < n - 1 else nn.Conv2d(d_out, d_in, 3, padding=1)])
            for i, (d_in, d_out) in enumerate(reversed(in_out)))
        self.final_res_block = ResnetBlock(dim * 2, dim, groups)
        self.output_layer = nn.Conv2d(dim, out_channels, 1)

    def forward(self, x):
        x = self.init_conv(x)
        r = x
        skips = []
        for block, down in self.downs:
            x = block(x)
            skips.append(x)
            x = down(x)
        x = self.mid_block(x)
        for block, up in self.ups:
            x = up(block(torch.cat([x, skips.pop()], 1)))
        x = self.final_res_block(torch.cat([x, r], 1))
        return self.output_layer(x)
