"""Plain UNet (counterpart of ``mfcnet_tpu/models/unet.py``; reference
models/unet.py:6-64). NCHW in and out; emits raw logits.

The reference's decoder unpools with ``MaxUnpool2d`` without the pooling
indices it never stores, so its forward cannot run; the JAX module takes
a nearest 2x upsample in its place (``ops/resize.py::resize_nearest``),
and so does this one. With no runnable reference there is no reference
checkpoint layout to follow: the modules carry the JAX module tree's
names (``UNetBlock_{i}`` with ``Conv_0`` and ``BatchNorm_0``,
``UpConv_{i}`` with ``Conv_0`` and ``UNetBlock_0``, the final
``Conv_0``), so a JAX checkpoint maps onto it name for name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mfcnet_tpu_torch.models.common import BatchNorm2d
from mfcnet_tpu_torch.ops.resize import resize_nearest

UNET_DIMS = (64, 128, 256, 512, 1024, 2048)


class UNetBlock(nn.Module):
    """Conv3x3 + BN (flax momentum 0.9, eps 1e-5) + ReLU (reference
    models/unet.py:6-17)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.BatchNorm_0 = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class UpConv(nn.Module):
    """Nearest 2x -> Conv3x3 -> concat skip -> UNetBlock (reference
    models/unet.py:19-31, the unpool as in the JAX module)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.UNetBlock_0 = UNetBlock(out_ch + skip_ch, out_ch)

    def forward(self, x, x_enc):
        x = resize_nearest(x, x.shape[-2] * 2, x.shape[-1] * 2)
        x = torch.cat([self.Conv_0(x), x_enc], 1)
        return self.UNetBlock_0(x)


class UNet(nn.Module):
    """Six UNetBlocks down (five 2x2 max-pools), five UpConvs back, a 1x1
    conv to ``output_channels``; ``dims`` shrinks for tests. Input H, W
    must be divisible by 32."""

    def __init__(self, output_channels: int, dims=UNET_DIMS,
                 in_ch: int = 3):
        super().__init__()
        d = tuple(dims)
        for i, c in enumerate(d):
            self.add_module(f"UNetBlock_{i}",
                            UNetBlock(in_ch if i == 0 else d[i - 1], c))
        for i in range(5):
            self.add_module(f"UpConv_{i}",
                            UpConv(d[5 - i], d[4 - i], d[4 - i]))
        self.Conv_0 = nn.Conv2d(d[0], output_channels, 1)

    def forward(self, x):
        skips = []
        for i in range(6):
            if i:
                skips.append(x)
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"UNetBlock_{i}")(x)
        for i in range(5):
            x = getattr(self, f"UpConv_{i}")(x, skips.pop())
        return self.Conv_0(x)
